# -*- coding: utf-8 -*-
"""
Benchmark + correctness gate for the fused detect reduction on one GPU.

Workload: the Icequake_Iceland detect geometry (259,008 grid nodes, 24
onsets, 625 scan samples per 2.5 s timestep at 250 Hz -- see BASELINE.md)
with a realistic homogeneous-moveout traveltime field.

Protocol:
1. Parity gate -- the detect reduction as compiled for the card (float32)
   must match the float64 reference (quakemigrate_tpu.ops.reference) on
   the same inputs: relative error <= 1e-5 on every sample's maximum and
   normalised maximum, and the argmax the reference's first index or a
   tie (the reference value at the chosen node within 1e-5 of the max).
2. Timing -- each call ends in ``block_until_ready``; best and median of
   several calls on distinct onset blocks, for the GPU program
   (ops.gather_migrate) and for the XLA shift-table program at each tile
   size of ``--tiles``. Windows: the short window, the day-scale window
   (30,000 samples) and a 2.1M-node regional grid.

A failing phase fails the run. Prints the card's name and power limit,
then ONE JSON line with the results last.

Run: python bench.py [--tiles 1024,2048,4096,8192]

"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# Icequake_Iceland detect geometry (BASELINE.md)
NX, NY, NZ = 71, 64, 57
N_ONSETS = 24
RATE = 250
TIMESTEP = 2.5
NSAMPLES = int(TIMESTEP * RATE)  # 625
FSMP = 475  # ~1.9 s pre-pad
LSMP = 575  # ~2.3 s post-pad
LONG_NSAMPLES = 30_000  # timestep 120 s
REGIONAL = (142, 128, 114)  # the same volume at half the node spacing

RTOL = 1e-5


def make_workload(seed=0, dims=None, spacing=0.025):
    """(onsets [O, T], traveltimes [nx, ny, nz, O]) for the short window."""

    nx, ny, nz = dims or (NX, NY, NZ)
    rng = np.random.default_rng(seed)
    onsets = rng.gamma(2.0, 1.5, size=(N_ONSETS, NSAMPLES + FSMP + LSMP))
    # Realistic traveltime field: homogeneous moveout from 24 pseudo-sources
    x, y, z = np.meshgrid(
        np.arange(nx) * spacing, np.arange(ny) * spacing,
        np.arange(nz) * spacing, indexing="ij",
    )
    tts = []
    for i in range(N_ONSETS):
        sx, sy = rng.uniform(0, nx * spacing), rng.uniform(0, ny * spacing)
        v = 3.63 if i < N_ONSETS // 2 else 1.833
        dist = np.sqrt((x - sx) ** 2 + (y - sy) ** 2 + z**2)
        tts.append(np.rint(dist / v * RATE).astype(np.int32))
    tt4d = np.stack(tts, axis=-1)
    # Clip to the valid range for the scan geometry
    tt4d = np.clip(tt4d, 0, LSMP)
    return onsets, tt4d


def require_gpu(jax):
    """The default device, which must be a GPU."""

    device = jax.devices()[0]
    if device.platform != "gpu":
        raise SystemExit(
            f"bench.py measures a GPU; JAX's default device is "
            f"{device.platform!r}"
        )
    return device


def card_description():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def parity_gate(out, ref_coa, ref_norm, ref_idx, ref_value_at):
    """
    Device float32 outputs (max_coa, max_norm, max_idx) vs the float64
    reference. ``ref_value_at(idx, t)`` gives reference map values at the
    device's chosen nodes, for the tie check where the nodes differ.

    """

    max_coa, max_norm, max_idx = (np.asarray(o) for o in out)
    err_coa = float(np.max(np.abs(max_coa - ref_coa) / ref_coa))
    err_norm = float(np.max(np.abs(max_norm - ref_norm) / ref_norm))
    differ = np.flatnonzero(max_idx != ref_idx)
    tie_err = 0.0
    if differ.size:
        at = ref_value_at(max_idx[differ].astype(np.int64), differ)
        tie_err = float(np.max((ref_coa[differ] - at) / ref_coa[differ]))
    return {
        "parity_ok": bool(err_coa <= RTOL and err_norm <= RTOL
                          and tie_err <= RTOL),
        "max_rel_err": err_coa,
        "norm_rel_err": err_norm,
        "argmax_differs": int(differ.size),
        "argmax_tie_rel_err": tie_err,
    }


def time_calls(fn, blocks, reps):
    """(best, median) seconds of ``fn(block)`` calls, each ending in
    block_until_ready, after one warm-up call (compilation)."""

    import jax

    jax.block_until_ready(fn(blocks[0]))
    times = []
    for i in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(blocks[i % len(blocks)]))
        times.append(time.perf_counter() - t0)
    return min(times), float(np.median(times))


def detect_programs(tt_dev, mask_dev, nsamples, n_nodes, tiles):
    """name -> callable(onset block) for the GPU program and the XLA
    shift-table program at each tile size."""

    from functools import partial

    import jax

    from quakemigrate_tpu.ops.migrate import (
        _detect_reduce_xla,
        _prepare_onsets,
        migrate_detect,
    )

    programs = {
        "gather": partial(
            migrate_detect, traveltimes=tt_dev, mask=mask_dev,
            available=float(N_ONSETS), fsmp=FSMP, nsamples=nsamples,
        )
    }

    for tile in tiles:
        @partial(jax.jit, static_argnames=("tile",))
        def xla(block, tile=tile):
            logged = _prepare_onsets(block, mask_dev)
            mx, idx, sm = _detect_reduce_xla(
                logged, tt_dev, mask_dev, float(N_ONSETS), 0, fsmp=FSMP,
                nsamples=nsamples, n_nodes_real=n_nodes, tile=tile,
            )
            return mx, mx * n_nodes / sm, idx

        programs[f"xla_tile{tile}"] = xla
    return programs


def bench_window(label, tt, nsamples, tiles, reps, seed):
    import jax

    n_nodes = tt.shape[0]
    rng = np.random.default_rng(seed)
    blocks = [
        jax.device_put(rng.gamma(2.0, 1.5, size=(
            N_ONSETS, FSMP + nsamples + LSMP)).astype(np.float32))
        for _ in range(3)
    ]
    tt_dev = jax.device_put(tt)
    mask_dev = jax.device_put(np.ones(N_ONSETS, np.float32))
    work = n_nodes * N_ONSETS * nsamples
    report = {}
    for name, fn in detect_programs(tt_dev, mask_dev, nsamples, n_nodes,
                                    tiles).items():
        best, median = time_calls(fn, blocks, reps)
        report[f"{label}_{name}_seconds"] = best
        report[f"{label}_{name}_seconds_median"] = median
        report[f"{label}_{name}_gsps"] = work / best / 1e9
        print(f"{label} {name}: best {best * 1e3:.3f} ms, median "
              f"{median * 1e3:.3f} ms", flush=True)
    return report


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--tiles", default="4096",
                        help="comma-separated XLA tile sizes to time")
    args = parser.parse_args(argv)
    tiles = [int(t) for t in args.tiles.split(",") if t]

    import jax

    from quakemigrate_tpu.ops import reference
    from quakemigrate_tpu.ops.migrate import migrate_detect

    device = require_gpu(jax)
    card = card_description()
    print(card, flush=True)

    onsets, tt4d = make_workload()
    tt = np.ascontiguousarray(tt4d.reshape(-1, N_ONSETS))
    mask = np.ones(N_ONSETS, np.float32)
    out = migrate_detect(
        jax.device_put(onsets.astype(np.float32)), jax.device_put(tt),
        jax.device_put(mask), float(N_ONSETS), FSMP, NSAMPLES,
    )
    onsets64 = onsets.astype(np.float32).astype(np.float64)
    ref_coa, ref_norm, ref_idx = reference.detect(
        onsets64, tt, FSMP, NSAMPLES, float(N_ONSETS)
    )

    def ref_value_at(nodes, cols):
        return reference.coalescence_at(
            onsets64, tt, FSMP, NSAMPLES, float(N_ONSETS), nodes, cols
        )

    gate = parity_gate(out, ref_coa, ref_norm, ref_idx, ref_value_at)
    print(f"parity: {gate}", flush=True)
    if not gate["parity_ok"]:
        raise SystemExit("parity gate failed")

    report = {"card": card, "device_kind": device.device_kind, **gate}
    report.update(bench_window("short", tt, NSAMPLES, tiles, reps=8, seed=3))
    report.update(bench_window("day", tt, LONG_NSAMPLES, tiles, reps=3,
                               seed=5))
    _, tt_regional = make_workload(seed=11, dims=REGIONAL, spacing=0.0125)
    report.update(bench_window(
        "regional", np.ascontiguousarray(tt_regional.reshape(-1, N_ONSETS)),
        NSAMPLES, tiles, reps=3, seed=13,
    ))
    headline = {
        "metric": "fused detect reduction throughput "
                  "(node*onset*samples/s), Icequake_Iceland short window",
        "value": report["short_gather_gsps"],
        "unit": "Gsamples/s",
        "parity_ok": gate["parity_ok"],
        "device": {"platform": device.platform, "kind": device.device_kind,
                   "count": 1},
    }
    print(json.dumps({**report, **headline}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
