# -*- coding: utf-8 -*-
"""
Pipelined locate (locate_workers > 0) must produce byte-identical
results to the fully serial path: events are independent, so the
worker-pool overlap (device migration of later events vs host
location/picks/writes of earlier ones) may only change scheduling,
never output. Guards the round-4 locate pipeline against shared-state
regressions (chip_smoke.py runs the same path at full size on a GPU).

"""

import pathlib

import numpy as np
import pandas as pd
import pytest

from quakemigrate_tpu import QuakeScan, compute_traveltimes
from quakemigrate_tpu.coords import Proj
from quakemigrate_tpu.io import Archive
from quakemigrate_tpu.seis import Trace, UTCDateTime
from quakemigrate_tpu.signal.onsets import STALTAOnset
from quakemigrate_tpu.synthetics import (
    GaussianDerivativeWavelet,
    simulate_waveforms,
)

SPS = 100
VP, VS = 5.0, 3.0
N_EVENTS = 4
DAY = "2021-02-18"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A compact multi-event world: 4 planted events 60 s apart."""

    root = tmp_path_factory.mktemp("locate_pipeline")

    gproj = Proj(proj="tmerc", units="km", lon_0=0.0, lat_0=0.0,
                 ellps="WGS84")
    cproj = Proj(proj="longlat", ellps="WGS84")
    rng = np.random.default_rng(11)
    angles = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    stations = pd.DataFrame({
        "Name": [f"PL{i:02d}" for i in range(8)],
        "Longitude": 0.045 * np.cos(angles),
        "Latitude": 0.045 * np.sin(angles),
        "Elevation": np.zeros(8),
    })
    lut = compute_traveltimes(
        dict(ll_corner=[-0.06, -0.06, 0.0], ur_corner=[0.06, 0.06, 20.0],
             node_spacing=[1.0, 1.0, 1.0], grid_proj=gproj,
             coord_proj=cproj),
        stations, method="homogeneous", phases=["P", "S"], vp=VP, vs=VS,
    )

    day_start = UTCDateTime(f"{DAY}T12:00:00.0")
    span = 60.0 * (N_EVENTS + 1)
    n_samples = int(span * SPS)
    wavelet = GaussianDerivativeWavelet(4.0, SPS, 10.0)

    planted = []
    streams = []
    for k in range(N_EVENTS):
        t_ev = 45.0 + 60.0 * k
        coords = [
            float(rng.uniform(-0.02, 0.02)),
            float(rng.uniform(-0.02, 0.02)),
            float(rng.uniform(8.0, 16.0)),
        ]
        streams.append(simulate_waveforms(
            wavelet, coords, lut, magnitude=2.0, angle_of_incidence=80,
            starttime=str(day_start + t_ev), rng=rng,
        ))
        planted.append((t_ev + 10.0, coords))  # wavelet zero ~ +half span

    day_dir = root / "mSEED" / "2021" / "049"
    day_dir.mkdir(parents=True)
    for name in stations["Name"]:
        for comp in "ZNE":
            data = rng.normal(scale=0.05, size=n_samples).astype(np.float32)
            for stream in streams:
                tr = stream.select(station=name, channel=f"CH{comp}")[0]
                i0 = int(round((tr.stats.starttime - day_start) * SPS))
                seg = tr.data.astype(np.float32)
                i1 = min(i0 + len(seg), n_samples)
                if i0 < n_samples:
                    data[i0:i1] += seg[: i1 - i0]
            Trace(
                np.round(data * 1000.0).astype(np.int32),
                {"station": name, "network": "PL", "channel": f"BH{comp}",
                 "sampling_rate": float(SPS), "starttime": day_start},
            ).write(str(day_dir / f"{name}_{comp}.m"), format="MSEED")

    # Trigger file straight from the planted catalogue (the locate stage
    # only needs EventID/CoaTime/TRIG_COA columns).
    rows = []
    for t_ev, coords in planted:
        coa_time = day_start + t_ev
        rows.append({
            "EventID": coa_time.strftime("%Y%m%d%H%M%S%f")[:17],
            "CoaTime": str(coa_time),
            "TRIG_COA": 2.0,
            "COA_X": coords[0], "COA_Y": coords[1], "COA_Z": coords[2],
            "COA": 2.0, "COA_NORM": 2.0,
        })
    trig_file = root / "triggers.csv"
    pd.DataFrame(rows).to_csv(trig_file, index=False)

    return root, stations, lut, trig_file


def _locate(world, run_name, **kwargs):
    root, stations, lut, trig_file = world
    archive = Archive(
        archive_path=root / "mSEED", stations=stations,
        archive_format="YEAR/JD/STATION",
    )
    onset = STALTAOnset(position="centred", sampling_rate=SPS)
    onset.phases = ["P", "S"]
    onset.bandpass_filters = {"P": [1, 12, 2], "S": [1, 12, 2]}
    onset.sta_lta_windows = {"P": [0.2, 1.0], "S": [0.2, 1.0]}
    scan = QuakeScan(
        archive, lut, onset=onset, run_path=str(root / "runs"),
        run_name=run_name, marginal_window=1.0, timestep=10.0,
        plot_event_summary=False, **kwargs,
    )
    scan.locate(trigger_file=str(trig_file))

    # Per-event dispatch marks (read by benchmarks for percentile
    # seconds/event) cover every located event exactly once:
    # dropped candidates never mark, located ones always do.
    out = root / "runs" / run_name / "locate"
    marks = scan.locate_event_marks
    n_located = len(list((out / "events").glob("*.event")))
    assert len(marks) == n_located
    assert all(m > 0 for m in marks)

    return out


def test_pipelined_locate_matches_serial(world):
    serial_dir = _locate(world, "serial", locate_workers=0)
    piped_dir = _locate(world, "piped", locate_workers=4)

    serial_events = sorted((serial_dir / "events").glob("*.event"))
    assert len(serial_events) == N_EVENTS, (
        f"serial path located {len(serial_events)}/{N_EVENTS}"
    )

    for f in serial_events:
        twin = piped_dir / "events" / f.name
        assert twin.is_file(), f"pipelined run missing {f.name}"
        assert f.read_bytes() == twin.read_bytes(), (
            f".event differs for {f.name}"
        )

    for f in sorted((serial_dir / "picks").glob("*.picks")):
        twin = piped_dir / "picks" / f.name
        assert twin.is_file()
        assert f.read_bytes() == twin.read_bytes(), (
            f".picks differs for {f.name}"
        )


def test_pipelined_locate_skips_dataless_event(world):
    """A candidate whose window has no archive data must be dropped
    cleanly by the pipelined scheduler while the surrounding events
    still locate (the drop path joins prepare-stage exceptions with the
    worker-pool machinery -- fresh round-4 code)."""

    root, stations, lut, trig_file = world
    table = pd.read_csv(trig_file)
    bad = table.iloc[:1].copy()
    # Outside the archive's span entirely
    bad["CoaTime"] = "2021-02-19T04:00:00.000000Z"
    bad["EventID"] = "20210219040000000"
    mixed_file = root / "triggers_with_gap.csv"
    # Dataless candidate sandwiched between real ones
    pd.concat([table.iloc[:2], bad, table.iloc[2:]]).to_csv(
        mixed_file, index=False
    )

    run_dir = _locate(
        (root, stations, lut, mixed_file), "withgap", locate_workers=4
    )
    located = sorted((run_dir / "events").glob("*.event"))
    names = {f.stem for f in located}
    assert len(located) == N_EVENTS, (
        f"expected {N_EVENTS} located, got {len(located)}"
    )
    assert "20210219040000000" not in names
