# -*- coding: utf-8 -*-
"""
Catalogue-scale trigger stress: 30 days of synthetic .scanmseed carrying
thousands of events through ``trigger()``, recording wall-clock and peak
memory per day -- the vectorised candidate merge is property-tested at
small sizes; this validates there is no quadratic blowup at volume
(reference workload shape: month-scale continuous scans,
reference signal/trigger.py trigger() day loop).

Recovery is matched, not counted: plants close enough to merge into a
single candidate (the reference's overlapping-marginal-window merge,
reference signal/trigger.py _refine_candidates / min_event_interval)
are collapsed into clusters, every trigger is associated to a cluster,
and cluster recall must be 100% with zero false triggers — so the
triggered-vs-planted shortfall is fully explained rather than left as
an unexplained deficit.

Writes .work/catalogue/result.json and a summary to stdout.
Exits non-zero if recall < 100% or the trigger count is not explained by
the merged clusters.

Run: PYTHONPATH=.:$PYTHONPATH python tools/catalogue_scale.py
"""

import json
import pathlib
import resource
import shutil
import sys
import time

import numpy as np
import pandas as pd

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD = ROOT / ".work" / "catalogue"

SPS = 50.0
N_DAYS = 30
EVENTS_PER_DAY = 130
START = "2015-06-01T00:00:00.0"
MATCH_TOL_S = 5.0   # |CoaTime - planted| tolerance (peaks shift when
                    # two wide wavelets overlap; plants are ~660 s apart
                    # on average, so a 5 s gate cannot cross-match)
MIN_EVENT_INTERVAL = 4.0


def build_lut():
    from quakemigrate_tpu import compute_traveltimes
    from quakemigrate_tpu.coords import Proj

    angles = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    stations = pd.DataFrame({
        "Name": [f"CT{i:02d}" for i in range(8)],
        "Longitude": -17.222 + 0.010 * np.cos(angles),
        "Latitude": 64.329 + 0.005 * np.sin(angles),
        "Elevation": np.zeros(8),
    })
    gproj = Proj(proj="lcc", units="km", lon_0=-17.222, lat_0=64.329,
                 lat_1=64.323, lat_2=64.335, datum="WGS84", ellps="WGS84",
                 no_defs=True)
    cproj = Proj(proj="longlat", datum="WGS84", ellps="WGS84", no_defs=True)
    return compute_traveltimes(
        dict(ll_corner=[-17.24, 64.322, -1.4],
             ur_corner=[-17.204, 64.336, 0.0],
             node_spacing=[0.1] * 3, grid_proj=gproj, coord_proj=cproj),
        stations, method="homogeneous", phases=["P", "S"],
        vp=3.630, vs=1.833,
    )


def synthesize_scanmseed(lut, rng):
    """Write N_DAYS of day-split scanmseed: noise floor + per-day planted
    coalescence peaks at random times/locations. Returns the planted
    catalogue as (seconds_since_START, amplitude, sigma) triples."""

    from quakemigrate_tpu.io.core import Run
    from quakemigrate_tpu.io.scanmseed import ScanmSEED
    from quakemigrate_tpu.seis import UTCDateTime

    shutil.rmtree(WORLD, ignore_errors=True)
    run = Run(str(WORLD / "runs"), "catalogue", stage="detect")
    ucf = lut.unit_conversion_factor
    n_day = int(86400 * SPS)
    t = np.arange(n_day) / SPS

    xmin, ymin, zmin = lut.grid_extent[0]
    xmax, ymax, zmax = lut.grid_extent[1]

    start = UTCDateTime(START)
    planted = []
    for day in range(N_DAYS):
        writer = ScanmSEED(run, False, SPS)
        coa = rng.normal(0.85, 0.08, n_day).astype(np.float64)
        coa_n = rng.normal(0.95, 0.06, n_day).astype(np.float64)
        coord = np.empty((n_day, 3))
        coord[:, 0] = rng.uniform(xmin, xmax, n_day)
        coord[:, 1] = rng.uniform(ymin, ymax, n_day)
        coord[:, 2] = rng.uniform(zmin, zmax, n_day)

        t_evs = np.sort(rng.uniform(30, 86400 - 30, EVENTS_PER_DAY))
        for t_ev in t_evs:
            amp = rng.uniform(1.5, 9.0)
            sigma = rng.uniform(0.5, 2.0)
            i0 = int((t_ev - 5 * sigma) * SPS)
            i1 = int((t_ev + 5 * sigma) * SPS)
            seg = np.exp(
                -0.5 * ((t[i0:i1] - t_ev) / sigma) ** 2
            )
            coa[i0:i1] += amp * seg
            coa_n[i0:i1] += amp * seg
            # A coherent location during the peak
            coord[i0:i1, 0] = rng.uniform(xmin, xmax)
            coord[i0:i1, 1] = rng.uniform(ymin, ymax)
            coord[i0:i1, 2] = rng.uniform(zmin, zmax)
            planted.append((day * 86400.0 + t_ev, amp, sigma))

        writer.append(start + day * 86400, coa, coa_n, coord, ucf)
        if len(writer.stream):
            writer.write()
    return planted


def planted_clusters(planted, threshold_excess=0.85):
    """Collapse the planted catalogue to the clusters the trigger's
    candidate merge can legally produce. Successive plants whose
    above-threshold runs could touch — gap below the sum of their
    above-threshold half-widths plus the enforced event interval — may
    share one trigger whose peak sits at the strongest plant (reference
    signal/trigger.py _refine_candidates / min_event_interval), so
    recall is asserted per *cluster*: a cluster is recovered when any
    trigger lands inside its planted time span (± tolerance). Returns
    [(t_lo, t_hi, n_plants)]."""

    clusters = []
    prev_end = -np.inf
    for t_ev, amp, sig in planted:
        w = sig * np.sqrt(
            2.0 * np.log(max(amp / threshold_excess, 1.0 + 1e-9))
        )
        if t_ev - w > prev_end + MIN_EVENT_INTERVAL or not clusters:
            clusters.append([t_ev, t_ev, 1])
        else:
            clusters[-1][1] = t_ev
            clusters[-1][2] += 1
        prev_end = max(prev_end, t_ev + w)
    return [tuple(c) for c in clusters]


def match_triggers(planted, trig_seconds, trig_coa):
    """day_e2e-style association of triggers to planted origins, scored
    at cluster granularity (plant-level recall reported alongside)."""

    clusters = planted_clusters(planted)
    matched = np.zeros(len(trig_seconds), dtype=bool)
    recovered_clusters, recovered_plants, missed = 0, 0, []
    for t_lo, t_hi, n_plants in clusters:
        near = np.where(
            (trig_seconds >= t_lo - MATCH_TOL_S)
            & (trig_seconds <= t_hi + MATCH_TOL_S)
        )[0]
        if near.size:
            matched[near] = True
            recovered_clusters += 1
            recovered_plants += n_plants
        else:
            missed.append(t_lo)
    n_false = int((~matched).sum())
    return {
        "mergeable_clusters": len(clusters),
        "clusters_recovered": recovered_clusters,
        "recall": round(recovered_clusters / max(len(clusters), 1), 4),
        "plants_in_recovered_clusters": recovered_plants,
        "plant_recall": round(recovered_plants / max(len(planted), 1), 4),
        "false_triggers": n_false,
        "precision": round(matched.sum() / max(len(trig_seconds), 1), 4),
        "match_tol_s": MATCH_TOL_S,
        "missed_origin_seconds": [round(t, 1) for t in missed[:20]],
        "false_trigger_coa_max": (
            round(float(trig_coa[~matched].max()), 3) if n_false else None
        ),
    }


def main():
    from quakemigrate_tpu import Trigger
    from quakemigrate_tpu.seis import UTCDateTime

    rng = np.random.default_rng(77)
    lut = build_lut()

    t0 = time.perf_counter()
    planted = synthesize_scanmseed(lut, rng)
    gen_s = time.perf_counter() - t0
    print(f"scanmseed synthesis: {gen_s:.1f} s for {N_DAYS} days")

    trig = Trigger(
        lut, run_path=str(WORLD / "runs"), run_name="catalogue",
        marginal_window=1.0, min_event_interval=4.0,
        normalise_coalescence=True, threshold_method="static",
        static_threshold=1.8, plot_trigger_summary=False,
    )
    end = str(UTCDateTime(START) + N_DAYS * 86400)
    t0 = time.perf_counter()
    trig.trigger(START, end)
    trig_s = time.perf_counter() - t0

    tables = [
        pd.read_csv(f) for f in sorted(
            (WORLD / "runs" / "catalogue" / "trigger" / "events")
            .glob("*.csv")
        )
    ]
    table = pd.concat(tables, ignore_index=True)
    start = UTCDateTime(START)
    trig_seconds = np.array([
        float(UTCDateTime(row) - start) for row in table["CoaTime"]
    ])
    recovery = match_triggers(planted, trig_seconds,
                              table["TRIG_COA"].values)
    clusters = recovery["mergeable_clusters"]

    peak_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    record = {
        "days": N_DAYS,
        "sps": SPS,
        "events_planted": len(planted),
        "events_triggered": len(table),
        **recovery,
        "synthesis_seconds": round(gen_s, 1),
        "trigger_seconds": round(trig_s, 1),
        "trigger_seconds_per_day": round(trig_s / N_DAYS, 2),
        "peak_rss_mb": round(peak_mb, 1),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    (WORLD / "result.json").write_text(json.dumps(record, indent=1))
    print(json.dumps(record, indent=1))

    ok = (
        recovery["recall"] == 1.0
        and recovery["false_triggers"] == 0
        and len(table) >= clusters
    )
    if not ok:
        print("FAIL: recall/precision/cluster accounting did not close")
        sys.exit(1)
    print(
        f"OK: cluster recall 100%, 0 false triggers; "
        f"{len(planted) - len(table)} plants merged into neighbours "
        f"(interval accounting allows {len(planted) - clusters})"
    )


if __name__ == "__main__":
    main()
