#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Smoke check of the detect -> trigger -> locate path on one NVIDIA GPU.

Phases (each one fails the run if it fails):

1. Environment: JAX version and devices, the card's name and power limit,
   the native STEIM library, pandas (required) and matplotlib (optional).
2. Kernel parity at full width: one fused detect window on the Icequake
   geometry (71 x 64 x 57 = 259,008 nodes, 24 onsets, 250 Hz) at 625 and
   at 30,000 scan samples, against the float64 reference
   (quakemigrate_tpu.ops.reference) computed on the host.
3. End to end: a synthetic ten-minute archive of the Icequake_Iceland
   deployment (its 13 stations, its 25 m grid, P and S) with planted
   events, through QuakeScan.detect (timestep 2.5 s, then 120 s),
   Trigger.trigger and QuakeScan.locate. Every planted event must be
   triggered, no trigger may be false, and every location must lie within
   4 node spacings of its planted source on the worst axis.

With ``--four-cards`` it runs only the four-card phase instead: the
phase-2 window and the phase-3 detect on a 1-D "grid" mesh and on a 2 x 2
("batch", "grid") mesh, compared with the same runs on one card.

The last line of standard output is one JSON object naming the device;
it is printed only when every phase passed.

Run:
    python chip_smoke.py                # one GPU
    python chip_smoke.py --four-cards   # four GPUs of one host

"""

import argparse
import contextlib
import json
import logging
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / ".smoke_work"

# Icequake_Iceland detect geometry (bench.make_workload)
N_ONSETS = 24
RATE = 250
FSMP, LSMP = 475, 575
SHORT, LONG = 625, 30_000  # scan samples: timestep 2.5 s and 120 s

RTOL = 1e-5  # float32 window vs float64 reference (see check_window)

# The Icequake_Iceland deployment (examples/Icequake_Iceland)
STATION_FILE = ROOT / "examples" / "Icequake_Iceland" / "inputs" / \
    "iceland_stations.txt"
GRID_SPEC = dict(
    ll_corner=[-17.24, 64.322, -1.4],
    ur_corner=[-17.204, 64.336, 0.0],
    node_spacing=[0.025, 0.025, 0.025],
)
VP, VS = 3.630, 1.833
DAY = "2014-06-29"
DATA_START = f"{DAY}T00:00:00.0"
SCAN_START = f"{DAY}T00:01:00.0"
SCAN_MINUTES = 10.0
EVENT_INTERVAL_S = 100.0
MARGINAL_WINDOW = 0.5
STATIC_THRESHOLD = 3.0
MATCH_TOL_S = 1.0
# Synthetic arrival-time jitter of about one sample at 250 Hz, and
# amplitude noise at the background level.
PICK_NOISE = {"traveltime": {"P": 0.005, "S": 0.005},
              "amplitude": {"P": 0.1, "S": 0.1}}
MAX_DELTA_NODES = 4.0


class SmokeFailure(Exception):
    """A phase did not meet its contract."""


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the four-card mesh phase (needs four GPUs)",
    )
    return parser.parse_args(argv)


def result_line(platform, kind, count):
    """The JSON object the run ends with."""

    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind,
                                "count": count}}
    )


def card_description():
    """Name and power limit of each card, as nvidia-smi reports them."""

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        raise SmokeFailure(f"nvidia-smi failed: {err}") from err
    if not out:
        raise SmokeFailure("nvidia-smi reported no card")
    return out


def gpu_devices(jax, count):
    """The first ``count`` devices, which must all be GPUs."""

    try:
        devices = jax.devices()
    except RuntimeError as err:
        raise SmokeFailure(f"JAX found no backend: {err}") from err
    if devices[0].platform != "gpu":
        raise SmokeFailure(
            f"JAX found no GPU (default platform {devices[0].platform!r})"
        )
    if len(devices) < count:
        raise SmokeFailure(f"need {count} GPUs, JAX sees {len(devices)}")
    return devices[:count]


@contextlib.contextmanager
def timed(label, stages):
    """Record the wall seconds of a stage in ``stages`` and print them."""

    t0 = time.perf_counter()
    yield
    stages[label] = time.perf_counter() - t0
    print(f"  {label}: {stages[label]:.2f} s", flush=True)


# ---------------------------------------------------------------------------
# Phase 1: environment
# ---------------------------------------------------------------------------


def phase_environment(jax, count):
    import importlib

    print(f"jax {jax.__version__}")
    devices = gpu_devices(jax, count)
    print(f"devices: {jax.devices()}")
    print(f"card: {card_description()}")

    from quakemigrate_tpu.core import native_available

    print(f"native STEIM library loaded: {native_available()}")
    if not native_available():
        raise SmokeFailure("the native STEIM library did not load")
    for module, required in (("pandas", True), ("matplotlib", False)):
        try:
            importlib.import_module(module)
            print(f"{module}: importable")
        except ImportError:
            print(f"{module}: not importable")
            if required:
                raise SmokeFailure(f"{module} is required")
    return devices


# ---------------------------------------------------------------------------
# Phase 2: kernel parity at full width
# ---------------------------------------------------------------------------


def window_inputs(nsamples, seed=0):
    """
    One fused detect window on the Icequake geometry: 12 stations x P/S
    slots of band-limited noise (P on the vertical, S on the horizontals)
    with a coherent pulse planted on the moveout of one node, and the
    homogeneous-moveout traveltime table of bench.py.

    """

    from bench import make_workload

    rng = np.random.default_rng(seed)
    _, tt4d = make_workload()
    tt = np.ascontiguousarray(tt4d.reshape(-1, N_ONSETS))
    t_len = FSMP + nsamples + LSMP
    channels = rng.normal(size=(N_ONSETS, 3, t_len)).astype(np.float32)
    chan_mask = np.zeros((N_ONSETS, 3), np.float32)
    chan_mask[: N_ONSETS // 2, 0] = 1.0
    chan_mask[N_ONSETS // 2:, 1:] = 1.0
    source = tt.shape[0] // 3
    t0 = nsamples // 2
    for o in range(N_ONSETS):
        i = FSMP + tt[source, o] + t0
        channels[o, :, i:i + 4] += 12.0
    slot_mask = np.ones(N_ONSETS, np.float32)
    nsta = np.array([3] * 12 + [13] * 12, np.int32)
    nlta = np.array([63] * 12 + [125] * 12, np.int32)
    return (channels, chan_mask, slot_mask, nsta, nlta), tt, t0


def check_window(name, got, ref, ref_at):
    """
    Compare a float32 window with the float64 reference. The window's
    error budget is ~24 logs x |log onset| (<~20) x 6e-8 and a float32
    sum over the grid; there is no matrix product, so TF32 plays no part.
    The argmax must be the reference's (first index) or a tie: the
    reference value at the chosen node within RTOL of the reference max.

    """

    max_coa, max_norm, max_idx = got
    ref_coa, ref_norm, ref_idx = ref
    err_coa = float(np.max(np.abs(max_coa - ref_coa) / ref_coa))
    err_norm = float(np.max(np.abs(max_norm - ref_norm) / ref_norm))
    differ = np.flatnonzero(max_idx != ref_idx)
    tie_err = 0.0
    if differ.size:
        at = ref_at(max_idx[differ], differ)
        tie_err = float(np.max((ref_coa[differ] - at) / ref_coa[differ]))
    print(f"  {name}: max_coa rel err {err_coa:.3e}, max_norm_coa rel err "
          f"{err_norm:.3e}, argmax differs at {differ.size} samples "
          f"(worst tie gap {tie_err:.3e})", flush=True)
    if not (np.all(np.isfinite(max_coa)) and err_coa <= RTOL
            and err_norm <= RTOL and tie_err <= RTOL):
        raise SmokeFailure(f"{name}: window disagrees with the reference")


def run_window(jax, nsamples, n_check=None, seed=0):
    """Run one fused window on the default GPU and hold it to the
    reference (on ``n_check`` evenly spread samples when given)."""

    from quakemigrate_tpu.ops import reference
    from quakemigrate_tpu.ops.scan_window import (
        detect_window_fused,
        fused_onsets,
    )

    inputs, tt, t0 = window_inputs(nsamples, seed)
    static = dict(position="classic", transform="energy",
                  min_onset_value=0.4)
    dev = [jax.device_put(a) for a in inputs]
    tt_dev = jax.device_put(tt)
    compiled = detect_window_fused.lower(
        *dev, tt_dev, fsmp=FSMP, nsamples=nsamples, **static
    ).compile()
    print(f"  window {nsamples}: {compiled.memory_analysis()}")
    got = [np.asarray(a) for a in jax.block_until_ready(
        compiled(*dev, tt_dev)
    )]

    onsets_fn = jax.jit(fused_onsets, static_argnums=(5, 6, 7))
    onsets, available = onsets_fn(*dev, "classic", "energy", 0.4)
    onsets = np.asarray(onsets, np.float64)
    available = float(available)
    mask = inputs[2]
    samples = np.arange(nsamples)
    if n_check is not None:
        samples = np.unique(np.concatenate([
            np.linspace(0, nsamples - 1, n_check).astype(int),
            np.arange(t0 - 8, t0 + 8),
        ]))
    ref = reference.detect(onsets, tt, FSMP, nsamples, available,
                           mask=mask, samples=samples)

    def ref_at(nodes, cols):
        return reference.coalescence_at(
            onsets, tt, FSMP, nsamples, available, nodes, samples[cols],
            mask=mask,
        )

    check_window(f"window {nsamples} samples ({len(samples)} checked)",
                 [g[samples] for g in got], ref, ref_at)
    return got


def phase_kernel_parity(jax):
    run_window(jax, SHORT)
    run_window(jax, LONG, n_check=256)


# ---------------------------------------------------------------------------
# Phase 3: detect -> trigger -> locate, end to end
# ---------------------------------------------------------------------------


def build_lut(spacing=None):
    from quakemigrate_tpu.coords import Proj
    from quakemigrate_tpu.io import read_stations
    from quakemigrate_tpu.lut import compute_traveltimes

    stations = read_stations(STATION_FILE)
    spec = dict(GRID_SPEC)
    if spacing is not None:
        spec["node_spacing"] = [spacing] * 3
    spec["grid_proj"] = Proj(
        proj="lcc", units="km", lon_0=-17.222, lat_0=64.329, lat_1=64.323,
        lat_2=64.335, datum="WGS84", ellps="WGS84", no_defs=True,
    )
    spec["coord_proj"] = Proj(proj="longlat", datum="WGS84", ellps="WGS84",
                              no_defs=True)
    lut = compute_traveltimes(spec, stations, method="homogeneous",
                              phases=["P", "S"], vp=VP, vs=VS)
    return lut, stations


def build_archive(lut, stations, root, minutes, seed=7):
    """
    Gaussian noise on every channel with icequake-like events (30 Hz
    wavelet, magnitude 1.5) planted about every EVENT_INTERVAL_S, written
    as day-file STEIM miniSEED. Returns the planted catalogue [(origin UTCDateTime,
    [lon, lat, z])].

    """

    from quakemigrate_tpu.seis import Trace, UTCDateTime
    from quakemigrate_tpu.synthetics import (
        GaussianDerivativeWavelet,
        simulate_waveforms,
    )

    rng = np.random.default_rng(seed)
    day_dir = root / "mSEED" / DAY[:4] / "180"
    day_dir.mkdir(parents=True)
    start = UTCDateTime(DATA_START)
    scan_start = UTCDateTime(SCAN_START)
    n_total = int((minutes + 3.0) * 60 * RATE)

    freq, half = 30.0, 1.0
    wavelet = GaussianDerivativeWavelet(freq, RATE, half)
    # the wavelet's zero time sits half + roll after the stream start
    origin_offset = half + (int(RATE * 0.5 / freq) + 3) / RATE
    events = []
    t_ev = float(scan_start - start) + 20.0
    end_s = float(scan_start - start) + minutes * 60.0 - 20.0
    while t_ev < end_s:
        coords = [-17.222 + float(rng.uniform(-0.006, 0.006)),
                  64.329 + float(rng.uniform(-0.003, 0.003)),
                  float(rng.uniform(-1.1, -0.3))]
        stream = simulate_waveforms(
            wavelet, coords, lut, magnitude=1.5, angle_of_incidence=80,
            starttime=str(start + t_ev), rng=rng, noise=PICK_NOISE,
        )
        events.append((start + t_ev + origin_offset, coords, stream))
        t_ev += EVENT_INTERVAL_S + float(rng.uniform(-15.0, 15.0))

    for name in stations["Name"]:
        for comp in "ZNE":
            data = rng.normal(scale=0.1, size=n_total)
            for _, _, stream in events:
                tr = stream.select(station=name, channel=f"CH{comp}")[0]
                i0 = int(round((tr.stats.starttime - start) * RATE))
                seg = tr.data[: max(0, n_total - i0)]
                data[i0:i0 + len(seg)] += seg
            Trace(
                np.round(data * 1000.0).astype(np.int32),
                {"station": name, "network": "SC", "channel": f"BH{comp}",
                 "sampling_rate": float(RATE), "starttime": start},
            ).write(str(day_dir / f"{name}_{comp}.m"), format="MSEED")
    return [(t, c) for t, c, _ in events]


def make_onset(position):
    from quakemigrate_tpu.signal.onsets import STALTAOnset

    onset = STALTAOnset(position=position, sampling_rate=RATE)
    onset.phases = ["P", "S"]
    onset.bandpass_filters = {"P": [10, 124, 4], "S": [10, 124, 4]}
    onset.sta_lta_windows = {"P": [0.01, 0.25], "S": [0.05, 0.5]}
    return onset


def make_scan(lut, stations, root, run_name, position="classic", **options):
    from quakemigrate_tpu import QuakeScan
    from quakemigrate_tpu.io import Archive

    archive = Archive(archive_path=root / "mSEED", stations=stations,
                      archive_format="YEAR/JD/STATION")
    return QuakeScan(
        archive, lut, onset=make_onset(position), run_path=str(root / "runs"),
        run_name=run_name, marginal_window=MARGINAL_WINDOW,
        plot_event_summary=False, **options,
    )


def scan_span(minutes):
    from quakemigrate_tpu.seis import UTCDateTime

    start = UTCDateTime(SCAN_START)
    return start, start + minutes * 60.0


def match_triggers(planted, table, span):
    """Associate each trigger with the nearest planted origin; returns
    (missed origins, false trigger times)."""

    from quakemigrate_tpu.seis import UTCDateTime

    t_trig = [UTCDateTime(t) for t in table["CoaTime"]]
    in_span = [t for t, _ in planted
               if span[0] <= t <= span[1] - MATCH_TOL_S]
    missed = [t for t in in_span
              if not any(abs(tt - t) <= MATCH_TOL_S for tt in t_trig)]
    false = [tt for tt in t_trig
             if not any(abs(tt - t) <= MATCH_TOL_S for t, _ in planted)]
    return missed, false


def delta_nodes(lut, a, b):
    """Worst-axis |a - b| in node spacings (lon/lat/z -> grid km)."""

    xyz_a = np.asarray(lut.coord2grid([a]))[0]
    xyz_b = np.asarray(lut.coord2grid([b]))[0]
    return float(np.max(np.abs(xyz_a - xyz_b) / lut.node_spacing))


def trigger_run(lut, root, run_name, span):
    import pandas as pd

    from quakemigrate_tpu import Trigger

    trig = Trigger(
        lut, run_path=str(root / "runs"), run_name=run_name,
        marginal_window=MARGINAL_WINDOW, min_event_interval=2.0,
        normalise_coalescence=False, threshold_method="static",
        static_threshold=STATIC_THRESHOLD, plot_trigger_summary=False,
    )
    trig.trigger(*span)
    tables = sorted((root / "runs" / run_name / "trigger" / "events")
                    .glob("*.csv"))
    if not tables:
        return pd.DataFrame(columns=["CoaTime", "TRIG_COA"])
    return pd.concat([pd.read_csv(f) for f in tables], ignore_index=True)


def coalescence_margins(root, run_name, planted):
    """(weakest peak COA near a planted origin, strongest COA elsewhere)
    from a detect run's scanmseed, for the record."""

    from quakemigrate_tpu.seis import read

    files = sorted((root / "runs" / run_name / "detect" / "scanmseed")
                   .glob("*.scanmseed"))
    coa = read(str(files[0])).select(station="COA")[0]
    values = coa.data / 1e5
    seconds = np.arange(len(values)) / coa.stats.sampling_rate
    near = np.zeros(len(values), bool)
    peaks = []
    for t, _ in planted:
        sel = np.abs(seconds - (t - coa.stats.starttime)) <= 3.0
        if sel.any():
            peaks.append(values[sel].max())
        near |= sel
    return (min(peaks) if peaks else None,
            float(values[~near].max()) if (~near).any() else None)


def phase_pipeline(minutes=SCAN_MINUTES, spacing=None, work=WORK):
    """Returns the stage seconds; raises SmokeFailure on any miss."""

    import pandas as pd

    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    stages = {}
    with timed("lut", stages):
        lut, stations = build_lut(spacing)
    print(f"  grid {tuple(lut.node_count)} = {int(np.prod(lut.node_count))} "
          f"nodes, {len(stations)} stations")
    with timed("archive", stages):
        planted = build_archive(lut, stations, work, minutes)
    print(f"  planted {len(planted)} events")
    span = scan_span(minutes)

    for timestep, run_name in ((2.5, "ts2p5"), (120.0, "ts120")):
        scan = make_scan(lut, stations, work, run_name, timestep=timestep)
        with timed(f"detect timestep {timestep} s", stages):
            scan.detect(*span)
        peak, noise = coalescence_margins(work, run_name, planted)
        print(f"  {run_name}: weakest event COA {peak}, strongest "
              f"noise COA {noise}, threshold {STATIC_THRESHOLD}")
        with timed(f"trigger timestep {timestep} s", stages):
            table = trigger_run(lut, work, run_name, span)
        missed, false = match_triggers(planted, table, span)
        print(f"  {run_name}: {len(table)} triggers, {len(missed)} planted "
              f"events missed, {len(false)} false triggers")
        if missed or false:
            raise SmokeFailure(
                f"{run_name}: missed {[str(t) for t in missed]}, false "
                f"{[str(t) for t in false]}"
            )

    scan = make_scan(lut, stations, work, "ts2p5", position="centred")
    with timed("locate", stages):
        scan.locate(*span)
    from quakemigrate_tpu.seis import UTCDateTime

    rows = [pd.read_csv(f).iloc[0] for f in sorted(
        (work / "runs" / "ts2p5" / "locate" / "events").glob("*.event"))]
    if len(rows) != len(table):
        raise SmokeFailure(f"located {len(rows)} of {len(table)} triggers")
    worst = 0.0
    for row in rows:
        t = UTCDateTime(row["DT"])
        origin, coords = min(planted, key=lambda p: abs(p[0] - t))
        err = delta_nodes(lut, [row["X"], row["Y"], row["Z"]], coords)
        worst = max(worst, err)
        print(f"  event {t}: located {[row['X'], row['Y'], row['Z']]}, "
              f"planted {np.round(coords, 5).tolist()}: {err:.2f} node "
              "spacings on the worst axis")
    if worst > MAX_DELTA_NODES:
        raise SmokeFailure(f"a location is {worst:.2f} node spacings off")
    stages["locate per event"] = stages["locate"] / max(len(rows), 1)
    print(f"  locate: {stages['locate per event']:.3f} s per event")
    return stages


# ---------------------------------------------------------------------------
# Phase 4: four cards
# ---------------------------------------------------------------------------


def shard_devices(array):
    return sorted(s.device.id for s in array.addressable_shards)


def phase_four_cards(jax, devices):
    from jax.sharding import NamedSharding, PartitionSpec

    from quakemigrate_tpu.ops.scan_window import detect_window_fused
    from quakemigrate_tpu.parallel import (
        make_mesh,
        make_sharded_detect_fused,
        pad_nodes_for_mesh,
    )

    inputs, tt, _ = window_inputs(SHORT)
    n_nodes = tt.shape[0]
    static = dict(position="classic", transform="energy",
                  min_onset_value=0.4, fsmp=FSMP, nsamples=SHORT)
    one = [np.asarray(a) for a in detect_window_fused(
        *(jax.device_put(a, devices[0]) for a in inputs),
        jax.device_put(tt, devices[0]), **static,
    )]

    def compare(name, got):
        got = [np.asarray(a) for a in got]
        same_idx = np.array_equal(got[2], one[2])
        same_coa = np.array_equal(got[0], one[0])
        err_norm = float(np.max(np.abs(got[1] - one[1]) / one[1]))
        print(f"  {name}: argmax identical {same_idx}, max_coa identical "
              f"{same_coa}, max_norm_coa rel err {err_norm:.3e}", flush=True)
        if not (same_idx and same_coa and err_norm <= RTOL):
            raise SmokeFailure(f"{name} disagrees with one card")

    grid_mesh = make_mesh(devices, axis_names=("grid",))
    tt_pad, _ = pad_nodes_for_mesh(tt, 4)
    tt_grid = jax.device_put(
        tt_pad, NamedSharding(grid_mesh, PartitionSpec("grid", None))
    )
    if shard_devices(tt_grid) != sorted(d.id for d in devices):
        raise SmokeFailure("the table is not split over the four cards")
    fused = make_sharded_detect_fused(
        grid_mesh, "classic", "energy", 0.4, FSMP, SHORT, n_nodes,
    )
    compare("window, 1-D grid mesh", fused(*inputs, tt_grid))

    mesh2 = make_mesh(devices, axis_names=("batch", "grid"), shape=(2, 2))
    tt_pad2, _ = pad_nodes_for_mesh(tt, 2)
    tt_b = jax.device_put(
        tt_pad2, NamedSharding(mesh2, PartitionSpec("grid", None))
    )
    batched = make_sharded_detect_fused(
        mesh2, "classic", "energy", 0.4, FSMP, SHORT, n_nodes,
        batch_axis="batch",
    )
    stack = [np.stack([a, a]) for a in inputs[:3]]
    out = batched(*stack, *inputs[3:], tt_b)
    for j in range(2):
        compare(f"window {j}, 2 x 2 batch x grid mesh",
                [o[j] for o in out])

    # Phase-3 detect: one card, then each mesh; scanmseed must agree
    minutes = 2.5
    work = WORK / "four"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    lut, stations = build_lut()
    build_archive(lut, stations, work, minutes)
    span = scan_span(minutes)
    runs = {
        "one": dict(),
        "grid": dict(mesh=grid_mesh),
        "batch_grid": dict(mesh=mesh2, detect_batch=4),
    }
    traces = {}
    from quakemigrate_tpu.seis import read

    for name, options in runs.items():
        scan = make_scan(lut, stations, work, name, timestep=2.5, **options)
        t0 = time.perf_counter()
        scan.detect(*span)
        print(f"  detect on {name}: {time.perf_counter() - t0:.2f} s")
        if "mesh" in options:
            held = shard_devices(scan._device_tt)
            if held != sorted(d.id for d in devices):
                raise SmokeFailure(f"{name}: table held by cards {held}")
        f = sorted((work / "runs" / name / "detect" / "scanmseed")
                   .glob("*.scanmseed"))[0]
        traces[name] = {tr.stats.station: tr.data for tr in read(str(f))}
    for name in ("grid", "batch_grid"):
        for station in ("COA", "X", "Y", "Z"):
            if not np.array_equal(traces[name][station],
                                  traces["one"][station]):
                raise SmokeFailure(f"detect on {name}: {station} differs")
        diff = np.abs(traces[name]["COA_N"].astype(np.int64)
                      - traces["one"]["COA_N"].astype(np.int64))
        if diff.max() > 1:  # scanmseed stores COA_N x 1e5 as integers
            raise SmokeFailure(f"detect on {name}: COA_N differs")
        print(f"  detect on {name}: scanmseed matches one card "
              f"(COA_N within {diff.max()} count)")


# ---------------------------------------------------------------------------


def main(argv=None):
    args = parse_args(argv)
    if not (ROOT / "quakemigrate_tpu").is_dir():
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    count = 4 if args.four_cards else 1
    t_start = time.perf_counter()
    try:
        import jax

        print("== phase 1: environment", flush=True)
        devices = phase_environment(jax, count)
        # The pipeline's own INFO logging would bury the phase summaries.
        logging.disable(logging.INFO)
        if args.four_cards:
            print("== phase 4: four cards", flush=True)
            phase_four_cards(jax, devices)
        else:
            print("== phase 2: kernel parity at full width", flush=True)
            phase_kernel_parity(jax)
            print("== phase 3: detect -> trigger -> locate", flush=True)
            phase_pipeline()
    except SmokeFailure as err:
        print(f"FAILED: {err}", file=sys.stderr)
        return 1
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card_description())
    first = devices[0]
    print(result_line(first.platform, first.device_kind, len(devices)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
