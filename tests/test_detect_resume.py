# -*- coding: utf-8 -*-
"""
detect(resume=True): a scan interrupted partway restarts at the first
missing timestep and the final outputs (scanmseed int32 payloads and the
availability table) are identical to an uninterrupted run.

"""

import numpy as np
import pandas as pd

from quakemigrate_tpu import QuakeScan, compute_traveltimes
from quakemigrate_tpu.coords import Proj
from quakemigrate_tpu.io import Archive
from quakemigrate_tpu.seis import read
from quakemigrate_tpu.signal.onsets import STALTAOnset
from quakemigrate_tpu.synthetics import (
    GaussianDerivativeWavelet,
    simulate_waveforms,
)

SPS = 100
START, MID, END = (
    "2021-02-18T12:00:20.0", "2021-02-18T12:00:35.0", "2021-02-18T12:00:45.0"
)


def _world(root):
    grid_spec = dict(
        ll_corner=[-0.04, -0.04, 0.0],
        ur_corner=[0.04, 0.04, 16.0],
        node_spacing=[2.0, 2.0, 2.0],
        grid_proj=Proj(proj="tmerc", units="km", lon_0=0.0, lat_0=0.0),
        coord_proj=Proj(proj="longlat"),
    )
    angles = np.linspace(0, 2 * np.pi, 6, endpoint=False)
    stations = pd.DataFrame(
        {
            "Name": [f"RS{i:02d}" for i in range(6)],
            "Longitude": 0.03 * np.cos(angles),
            "Latitude": 0.03 * np.sin(angles),
            "Elevation": np.zeros(6),
        }
    )
    lut = compute_traveltimes(
        grid_spec, stations, method="homogeneous", phases=["P", "S"],
        vp=5.0, vs=3.0,
    )
    wavelet = GaussianDerivativeWavelet(4.0, SPS, 30.0)
    stream = simulate_waveforms(
        wavelet, [0.0, 0.0, 10.0], lut, magnitude=2.0,
        rng=np.random.default_rng(5),
    )
    day_dir = root / "mSEED" / "2021" / "049"
    day_dir.mkdir(parents=True)
    for tr in stream:
        tr.write(str(day_dir / f"{tr.stats.station}_{tr.stats.channel[-1]}.m"),
                 format="MSEED")
    return Archive(archive_path=root / "mSEED", stations=stations,
                   archive_format="YEAR/JD/STATION"), lut


def _scan(archive, lut, root, name):
    onset = STALTAOnset(position="classic", sampling_rate=SPS)
    onset.phases = ["P", "S"]
    onset.bandpass_filters = {"P": [1, 12, 2], "S": [1, 12, 2]}
    onset.sta_lta_windows = {"P": [0.2, 1.0], "S": [0.2, 1.0]}
    return QuakeScan(
        archive, lut, onset=onset, run_path=str(root / "runs"),
        run_name=name, timestep=5.0, precision="double",
    )


def test_resumed_detect_matches_uninterrupted(tmp_path):
    archive, lut = _world(tmp_path)

    # Uninterrupted run
    scan = _scan(archive, lut, tmp_path, "whole")
    scan.detect(START, END)

    # The batch-throughput marks benchmarks read cover every scanned
    # window exactly once.
    marks = scan.detect_batch_marks
    assert sum(n for n, _ in marks) == 5  # 25 s span / 5 s timestep
    assert all(secs > 0 for _, secs in marks)

    # "Crashed" run: first 3 timesteps, then resume over the full span
    _scan(archive, lut, tmp_path, "pieces").detect(START, MID)
    _scan(archive, lut, tmp_path, "pieces").detect(START, END, resume=True)

    base = tmp_path / "runs"
    whole = read(str(base / "whole" / "detect" / "scanmseed"
                     / "2021_049.scanmseed"))
    pieces = read(str(base / "pieces" / "detect" / "scanmseed"
                      / "2021_049.scanmseed"))
    for channel in ("COA", "COA_N", "X", "Y", "Z"):
        a = whole.select(station=channel)[0]
        b = pieces.select(station=channel)[0]
        assert a.stats.starttime == b.stats.starttime
        assert a.stats.npts == b.stats.npts, channel
        np.testing.assert_array_equal(a.data, b.data, err_msg=channel)

    av_whole = pd.read_csv(
        base / "whole" / "detect" / "availability"
        / "2021_049_StationAvailability.csv", index_col=0,
    )
    av_pieces = pd.read_csv(
        base / "pieces" / "detect" / "availability"
        / "2021_049_StationAvailability.csv", index_col=0,
    )
    pd.testing.assert_frame_equal(av_whole, av_pieces)


def test_resume_noop_when_complete(tmp_path, capsys):
    archive, lut = _world(tmp_path)
    scan = _scan(archive, lut, tmp_path, "done")
    scan.detect(START, END)
    before = (tmp_path / "runs" / "done" / "detect" / "scanmseed"
              / "2021_049.scanmseed").read_bytes()
    _scan(archive, lut, tmp_path, "done").detect(START, END, resume=True)
    after = (tmp_path / "runs" / "done" / "detect" / "scanmseed"
             / "2021_049.scanmseed").read_bytes()
    assert before == after


def test_resume_tolerates_corrupt_partial_file(tmp_path):
    """A crash mid-write can leave a truncated/empty day file; resume
    must treat it as unscanned instead of dying with IndexError
    (regression)."""

    archive, lut = _world(tmp_path)
    scandir = tmp_path / "runs" / "crashy" / "detect" / "scanmseed"
    scandir.mkdir(parents=True)
    (scandir / "2021_049.scanmseed").write_bytes(b"")  # zero-byte file

    _scan(archive, lut, tmp_path, "crashy").detect(START, END, resume=True)
    st = read(str(scandir / "2021_049.scanmseed"))
    assert st.select(station="COA")[0].stats.npts == 25 * SPS


def test_resume_ignores_unrelated_day_file(tmp_path):
    """A day file whose coverage starts AFTER the requested starttime
    (e.g. from an earlier different-span run) must not fast-forward past
    the unscanned span before it (regression)."""

    archive, lut = _world(tmp_path)

    # Earlier run covering only a LATER slice of the span
    _scan(archive, lut, tmp_path, "gap").detect(MID, END)
    mid_bytes = (tmp_path / "runs" / "gap" / "detect" / "scanmseed"
                 / "2021_049.scanmseed").read_bytes()
    assert len(mid_bytes)

    # Resume over the full span: the file does not start at START, so
    # the whole span must be rescanned
    _scan(archive, lut, tmp_path, "gap").detect(START, END, resume=True)
    st = read(str(tmp_path / "runs" / "gap" / "detect" / "scanmseed"
                  / "2021_049.scanmseed"))
    coa = st.select(station="COA")[0]
    from quakemigrate_tpu.seis import UTCDateTime

    assert coa.stats.starttime == UTCDateTime(START)
    assert coa.stats.npts == 25 * SPS
    assert (coa.data[: 5 * SPS] != 0).any()  # the early span was scanned
