# -*- coding: utf-8 -*-
"""
Golden-file parity against the reference's committed Icequake_Iceland
benchmark outputs (real data): rebuild the LUT from the published grid
spec, re-run locate on the benchmark's cut waveforms using the published
run parameters, and compare the resulting .event and .picks files with the
golden ones. Acceptance: locations within ~1 grid node, picks within ~1
sample (BASELINE.md).

Skipped if the reference checkout is unavailable.

"""

import pathlib
import shutil

import numpy as np
import pandas as pd
import pytest

from quakemigrate_tpu import QuakeScan, compute_traveltimes
from quakemigrate_tpu.coords import Proj
from quakemigrate_tpu.io import Archive, read_stations
from quakemigrate_tpu.seis import UTCDateTime
from quakemigrate_tpu.signal.onsets import STALTAOnset

from oracle import REFERENCE_PATH

BENCH = REFERENCE_PATH / "examples" / "benchmarks" / "Icequake_Iceland"
STATION_FILE = (
    REFERENCE_PATH / "examples" / "Icequake_Iceland" / "inputs"
    / "iceland_stations.txt"
)

pytestmark = pytest.mark.skipif(
    not BENCH.exists(), reason="reference benchmark files unavailable"
)

# Grid/run parameters as published in the reference example scripts
# (iceland_lut.py, iceland_locate.py)
NODE_SPACING = 0.025  # km


@pytest.fixture(scope="module")
def located_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("iceland_parity")

    stations = read_stations(STATION_FILE)

    gproj = Proj(
        proj="lcc", units="km", lon_0=-17.222, lat_0=64.329, lat_1=64.323,
        lat_2=64.335, datum="WGS84", ellps="WGS84", no_defs=True,
    )
    cproj = Proj(proj="longlat", datum="WGS84", ellps="WGS84", no_defs=True)
    grid_spec = dict(
        ll_corner=[-17.24, 64.322, -1.4],
        ur_corner=[-17.204, 64.336, 0.0],
        node_spacing=[NODE_SPACING] * 3,
        grid_proj=gproj,
        coord_proj=cproj,
    )
    lut = compute_traveltimes(
        grid_spec, stations, method="homogeneous", phases=["P", "S"],
        vp=3.630, vs=1.833,
    )

    # Archive = the benchmark's per-event cut waveforms (exactly the locate
    # read windows). Overlapping events carry identical samples, so the
    # no-clobber merge joins them.
    day_dir = root / "mSEED" / "2014" / "180"
    day_dir.mkdir(parents=True)
    for m_file in BENCH.glob("*.m"):
        shutil.copy(m_file, day_dir / m_file.name)

    archive = Archive(
        archive_path=root / "mSEED", stations=stations,
        format="{year}/{jday:03d}/*",
    )

    onset = STALTAOnset(position="centred", sampling_rate=250)
    onset.phases = ["P", "S"]
    onset.bandpass_filters = {"P": [10, 124, 4], "S": [10, 124, 4]}
    onset.sta_lta_windows = {"P": [0.01, 0.25], "S": [0.05, 0.5]}

    scan = QuakeScan(
        archive, lut, onset=onset, run_path=str(root / "runs"),
        run_name="parity", marginal_window=0.06, precision="double",
    )
    scan.locate(trigger_file=str(BENCH / "example_run_2014_180_TriggeredEvents.csv"))

    return root / "runs" / "parity" / "locate", lut


def test_event_parity(located_run):
    locate_dir, lut = located_run

    golden_events = sorted(BENCH.glob("*.event"))
    assert golden_events

    # ~1 node spacing in degrees at this latitude
    deg_per_km_lat = 1 / 111.2
    deg_per_km_lon = 1 / (111.2 * np.cos(np.deg2rad(64.33)))
    tol_x = 1.2 * NODE_SPACING * deg_per_km_lon
    tol_y = 1.2 * NODE_SPACING * deg_per_km_lat
    tol_z = 1.2 * NODE_SPACING  # km

    for golden_file in golden_events:
        ours_file = locate_dir / "events" / golden_file.name
        assert ours_file.exists(), f"event {golden_file.name} not located"
        golden = pd.read_csv(golden_file).iloc[0]
        ours = pd.read_csv(ours_file).iloc[0]

        # Origin time within one scan sample (250 Hz)
        dt = abs(UTCDateTime(ours["DT"]) - UTCDateTime(golden["DT"]))
        assert dt <= 1 / 250 + 1e-9, f"{golden_file.name}: otime off by {dt}"

        # Spline location within ~1 node
        assert abs(ours["X"] - golden["X"]) < tol_x, golden_file.name
        assert abs(ours["Y"] - golden["Y"]) < tol_y, golden_file.name
        assert abs(ours["Z"] - golden["Z"]) < tol_z, golden_file.name

        # Coalescence values within 2%
        assert abs(ours["COA"] - golden["COA"]) / golden["COA"] < 0.02
        assert (
            abs(ours["COA_NORM"] - golden["COA_NORM"]) / golden["COA_NORM"]
            < 0.02
        )

        # Gaussian location within ~2 nodes (fit on a smoothed map)
        assert abs(ours["GAU_X"] - golden["GAU_X"]) < 2 * tol_x
        assert abs(ours["GAU_Y"] - golden["GAU_Y"]) < 2 * tol_y
        assert abs(ours["GAU_Z"] - golden["GAU_Z"]) < 2 * tol_z


def test_picks_parity(located_run):
    locate_dir, lut = located_run

    total, matched = 0, 0
    for golden_file in sorted(BENCH.glob("*.picks")):
        ours_file = locate_dir / "picks" / golden_file.name
        assert ours_file.exists()
        golden = pd.read_csv(golden_file)
        ours = pd.read_csv(ours_file)

        merged = golden.merge(
            ours, on=["Station", "Phase"], suffixes=("_ref", "_ours")
        )
        assert len(merged) == len(golden)

        for _, row in merged.iterrows():
            ref_made = str(row["PickTime_ref"]) != "-1"
            ours_made = str(row["PickTime_ours"]) != "-1"
            if not ref_made:
                continue
            total += 1
            if not ours_made:
                continue
            diff = abs(
                UTCDateTime(str(row["PickTime_ours"]))
                - UTCDateTime(str(row["PickTime_ref"]))
            )
            if diff <= 2 / 250:  # within 2 onset samples
                matched += 1

    assert total > 0
    # Every reference-made pick is reproduced within 2 samples on the
    # current tree (tools/pick_audit.py, round 4: 23/23) -- hold the
    # line at 100%. Misses, if they ever reappear, must be classified
    # and allowlisted with a reason, not absorbed by a ratio threshold.
    assert matched == total, f"only {matched}/{total} picks match"
