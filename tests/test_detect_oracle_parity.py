# -*- coding: utf-8 -*-
"""
End-to-end detect parity against the reference C kernels.

A synthetic continuous archive is scanned twice:

1. by this package's detect() (fused device program, float64 precision);
2. by a step-by-step re-implementation of the *reference's* detect chain
   (quakemigrate/signal/scan.py:593-647): per timestep, read waveforms ->
   calculate onsets -> serve traveltimes -> reference C ``migrate`` ->
   reference C ``find_max_coa`` -> index2coord -> int32 scanmseed append,
   with the C kernels compiled from the read-only reference checkout.

The two day-split .scanmseed files must agree int32-for-int32 on every
channel — any one-count drift in COA/COA_N/X/Y/Z fails.

"""

import numpy as np
import pandas as pd
import pytest

import quakemigrate_tpu.util as util
from quakemigrate_tpu import QuakeScan, compute_traveltimes
from quakemigrate_tpu.coords import Proj
from quakemigrate_tpu.io import Archive, Run, ScanmSEED
from quakemigrate_tpu.seis import UTCDateTime, read
from quakemigrate_tpu.signal.onsets import STALTAOnset
from quakemigrate_tpu.synthetics import (
    GaussianDerivativeWavelet,
    simulate_waveforms,
)

from oracle import load_oracle, oracle_find_max_coa, oracle_migrate

SPS = 100
TIMESTEP = 5.0
START = "2021-02-18T12:00:20.0"
END = "2021-02-18T12:00:45.0"


def _build_world(root):
    """Synthetic archive + LUT + onset (one planted event mid-span)."""

    grid_spec = dict(
        ll_corner=[-0.04, -0.04, 0.0],
        ur_corner=[0.04, 0.04, 16.0],
        node_spacing=[1.0, 1.0, 1.0],
        grid_proj=Proj(proj="tmerc", units="km", lon_0=0.0, lat_0=0.0),
        coord_proj=Proj(proj="longlat"),
    )
    angles = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    stations = pd.DataFrame(
        {
            "Name": [f"SY{i:02d}" for i in range(8)],
            "Longitude": 0.03 * np.cos(angles),
            "Latitude": 0.03 * np.sin(angles),
            "Elevation": np.zeros(8),
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
        tr.write(
            str(day_dir / f"{tr.stats.station}_{tr.stats.channel[-1]}.m"),
            format="MSEED",
        )

    archive = Archive(
        archive_path=root / "mSEED", stations=stations,
        archive_format="YEAR/JD/STATION",
    )

    return archive, lut


def _make_onset(position, transform):
    onset = STALTAOnset(
        position=position, sampling_rate=SPS, signal_transform=transform
    )
    onset.phases = ["P", "S"]
    onset.bandpass_filters = {"P": [1, 12, 2], "S": [1, 12, 2]}
    onset.sta_lta_windows = {"P": [0.2, 1.0], "S": [0.2, 1.0]}
    return onset


def _reference_detect(run_path, archive, lut, onset):
    """The reference's detect chain, with its C kernels as the compute core."""

    run = Run(run_path, "oracle_side", "", "detect")
    onset.post_pad = lut.max_traveltime
    pre_pad, post_pad = onset.pad(TIMESTEP)
    ucf = lut.unit_conversion_factor

    start, end = UTCDateTime(START), UTCDateTime(END)
    n_steps = int(np.ceil((end - start) / TIMESTEP))

    stream = ScanmSEED(run, False, SPS)
    for i in range(n_steps):
        w_beg = start + TIMESTEP * i - pre_pad
        w_end = start + TIMESTEP * (i + 1) - 1 / SPS + post_pad
        try:
            data = archive.read_waveform_data(w_beg, w_end)
            onsets, onset_data = onset.calculate_onsets(data)
        except (
            util.ArchiveEmptyException,
            util.DataGapException,
            util.DataAvailabilityException,
        ) as e:
            stream.empty(start, TIMESTEP, i, e.msg, ucf)
            continue

        traveltimes = lut.serve_traveltimes(
            onset_data.sampling_rate, onset_data.availability
        )
        fsmp = util.time2sample(pre_pad, onset_data.sampling_rate)
        lsmp = util.time2sample(post_pad, onset_data.sampling_rate)
        avail = int(np.sum(list(onset_data.availability.values())))

        map4d = oracle_migrate(onsets, traveltimes, fsmp, lsmp, avail)
        max_coa, max_coa_n, max_idx = oracle_find_max_coa(map4d)
        coord = lut.index2coord(max_idx, unravel=True)
        stream.append(data.starttime + pre_pad, max_coa, max_coa_n, coord, ucf)

    if not stream.written:
        stream.write()
    return run.path / "detect" / "scanmseed" / "2021_049.scanmseed"


# (position, signal_transform) configurations: the Icequake style and the
# VT style (centred windows on squared envelopes).
_CONFIGS = [("classic", "energy"), ("centred", "env_squared")]


@pytest.fixture(scope="module", params=_CONFIGS, ids=lambda c: "_".join(c))
def scanmseed_pair(tmp_path_factory, request):
    if load_oracle() is None:
        pytest.skip("reference C oracle unavailable")
    position, transform = request.param
    root = tmp_path_factory.mktemp(f"oracle_detect_{position}")
    archive, lut = _build_world(root)

    scan = QuakeScan(
        archive, lut, onset=_make_onset(position, transform),
        run_path=str(root / "runs"),
        run_name="ours_side", timestep=TIMESTEP, precision="double",
        plot_event_summary=False,
    )
    scan.detect(START, END)
    ours = (
        root / "runs" / "ours_side" / "detect" / "scanmseed"
        / "2021_049.scanmseed"
    )

    theirs = _reference_detect(
        str(root / "runs"), archive, lut, _make_onset(position, transform)
    )
    return ours, theirs


def test_detect_scanmseed_int32_parity(scanmseed_pair):
    ours, theirs = scanmseed_pair
    assert ours.exists() and theirs.exists()

    st_ours, st_theirs = read(str(ours)), read(str(theirs))
    assert len(st_ours) == len(st_theirs) == 5

    # Guard against a degenerate all-zeros pass: the planted event must
    # actually raise the coalescence above background (COA scaled by 1e5).
    assert st_ours.select(station="COA")[0].data.max() > 1.2e5

    for channel in ("COA", "COA_N", "X", "Y", "Z"):
        a = st_ours.select(station=channel)[0]
        b = st_theirs.select(station=channel)[0]
        assert a.stats.starttime == b.stats.starttime, channel
        assert a.stats.npts == b.stats.npts, channel
        mismatch = np.flatnonzero(a.data != b.data)
        assert mismatch.size == 0, (
            f"{channel}: {mismatch.size} int32 samples differ "
            f"(first at {mismatch[:5]}, "
            f"ours={a.data[mismatch[:5]]}, ref={b.data[mismatch[:5]]})"
        )


def test_detect_scanmseed_merge_contract(scanmseed_pair):
    """
    The reference's benchmark-suite assertion, on a reference-generated
    synthetic day (ref tests/test_benchmarks.py:101-105): the repo's day
    stream ADDED to the reference-chain day stream must merge
    conflict-free -- merge(method=-1) raises on any overlapping sample
    whose int32 values disagree, so this pins the full detect -> scale ->
    round -> STEIM encode -> decode contract, not just the in-memory
    arrays.

    """

    ours, theirs = scanmseed_pair
    combined = read(str(ours)) + read(str(theirs))
    assert len(combined) == 10
    combined.merge(method=-1)  # util.MergeError on any conflicting sample
    assert len(combined) == 5
    npts = read(str(ours)).select(station="COA")[0].stats.npts
    for tr in combined:
        assert tr.stats.npts == npts, tr.stats.station
