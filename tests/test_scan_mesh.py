# -*- coding: utf-8 -*-
"""
QuakeScan with a device mesh: detect over the virtual 8-device CPU mesh
must write a byte-identical .scanmseed to the single-device run.

"""

import numpy as np
import pandas as pd
import pytest

import jax

from quakemigrate_tpu import QuakeScan, compute_traveltimes
from quakemigrate_tpu.coords import Proj
from quakemigrate_tpu.io import Archive
from quakemigrate_tpu.parallel import make_mesh
from quakemigrate_tpu.signal.onsets import STALTAOnset
from quakemigrate_tpu.synthetics import GaussianDerivativeWavelet, simulate_waveforms

SPS = 100


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("meshscan")

    gproj = Proj(proj="tmerc", units="km", lon_0=0.0, lat_0=0.0)
    cproj = Proj(proj="longlat")
    grid_spec = dict(
        ll_corner=[-0.06, -0.06, 0.0],
        ur_corner=[0.06, 0.06, 20.0],
        node_spacing=[2.0, 2.0, 2.0],
        grid_proj=gproj,
        coord_proj=cproj,
    )
    angles = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    stations = pd.DataFrame(
        {
            "Name": [f"ST{i:02d}" for i in range(8)],
            "Longitude": 0.045 * np.cos(angles),
            "Latitude": 0.045 * np.sin(angles),
            "Elevation": np.zeros(8),
        }
    )
    lut = compute_traveltimes(
        grid_spec, stations, method="homogeneous", phases=["P", "S"],
        vp=5.0, vs=3.0,
    )

    wavelet = GaussianDerivativeWavelet(4.0, SPS, 30.0)
    # Steep incidence so P rides the vertical and S the horizontals
    # (the default 0 makes the ray horizontal and swaps them).
    stream = simulate_waveforms(
        wavelet, [0.0, 0.0, 12.0], lut, magnitude=2.0,
        angle_of_incidence=80, rng=np.random.default_rng(7),
    )
    day_dir = root / "mSEED" / "2021" / "049"
    day_dir.mkdir(parents=True)
    for tr in stream:
        tr.write(str(day_dir / f"{tr.stats.station}_{tr.stats.channel[-1]}.m"),
                 format="MSEED")

    archive = Archive(
        archive_path=root / "mSEED", stations=stations,
        archive_format="YEAR/JD/STATION",
    )
    return root, archive, lut


def _run_detect(root, archive, lut, name, mesh):
    onset = STALTAOnset(position="classic", sampling_rate=SPS)
    onset.phases = ["P", "S"]
    onset.bandpass_filters = {"P": [1, 12, 2], "S": [1, 12, 2]}
    onset.sta_lta_windows = {"P": [0.2, 1.0], "S": [0.2, 1.0]}
    scan = QuakeScan(
        archive, lut, onset=onset, run_path=str(root / "runs"),
        run_name=name, marginal_window=1.0, timestep=5.0, mesh=mesh,
        tile=64, fused_detect=False,
    )
    scan.detect("2021-02-18T12:00:20.0", "2021-02-18T12:00:40.0")
    return root / "runs" / name / "detect" / "scanmseed" / "2021_049.scanmseed"


def test_mesh_detect_matches_single_device(setup):
    root, archive, lut = setup

    single = _run_detect(root, archive, lut, "single", None)
    mesh = make_mesh(jax.devices())
    sharded = _run_detect(root, archive, lut, "sharded", mesh)

    from quakemigrate_tpu.seis import read

    st_single = read(str(single))
    st_sharded = read(str(sharded))
    for station in ("COA", "X", "Y", "Z"):
        a = st_single.select(station=station)[0].data
        b = st_sharded.select(station=station)[0].data
        np.testing.assert_array_equal(a, b, err_msg=station)
    # COA_N divides by the cross-shard psum: summation-order rounding may
    # flip the last retained digit (1e-5) on isolated samples
    a = st_single.select(station="COA_N")[0].data.astype(np.int64)
    b = st_sharded.select(station="COA_N")[0].data.astype(np.int64)
    assert np.abs(a - b).max() <= 1
    assert (a != b).mean() < 0.05


def test_batched_detect_matches_unbatched(setup):
    root, archive, lut = setup

    def run(name, batch):
        onset = STALTAOnset(position="classic", sampling_rate=SPS)
        onset.phases = ["P", "S"]
        onset.bandpass_filters = {"P": [1, 12, 2], "S": [1, 12, 2]}
        onset.sta_lta_windows = {"P": [0.2, 1.0], "S": [0.2, 1.0]}
        scan = QuakeScan(
            archive, lut, onset=onset, run_path=str(root / "runs"),
            run_name=name, marginal_window=1.0, timestep=5.0, tile=64,
            detect_batch=batch, fused_detect=False,
        )
        scan.detect("2021-02-18T12:00:20.0", "2021-02-18T12:00:40.0")
        return (
            root / "runs" / name / "detect" / "scanmseed"
            / "2021_049.scanmseed"
        )

    single = run("single2", 1)
    batched = run("batched", 3)
    assert single.read_bytes() == batched.read_bytes()


def test_fused_detect_matches_standard(setup):
    root, archive, lut = setup

    def run(name, fused):
        onset = STALTAOnset(position="classic", sampling_rate=SPS)
        onset.phases = ["P", "S"]
        onset.bandpass_filters = {"P": [1, 12, 2], "S": [1, 12, 2]}
        onset.sta_lta_windows = {"P": [0.2, 1.0], "S": [0.2, 1.0]}
        scan = QuakeScan(
            archive, lut, onset=onset, run_path=str(root / "runs"),
            run_name=name, marginal_window=1.0, timestep=5.0, tile=64,
            fused_detect=fused, precision="double",
        )
        scan.detect("2021-02-18T12:00:20.0", "2021-02-18T12:00:40.0")
        return (
            root / "runs" / name / "detect" / "scanmseed"
            / "2021_049.scanmseed"
        )

    unfused = run("unfused", False)
    fused = run("fused", True)
    assert unfused.read_bytes() == fused.read_bytes()


def test_fused_mesh_detect_matches_fused_single(setup):
    """The whole fused window program sharded over the 8-device mesh."""

    root, archive, lut = setup

    def run(name, mesh):
        onset = STALTAOnset(position="classic", sampling_rate=SPS)
        onset.phases = ["P", "S"]
        onset.bandpass_filters = {"P": [1, 12, 2], "S": [1, 12, 2]}
        onset.sta_lta_windows = {"P": [0.2, 1.0], "S": [0.2, 1.0]}
        scan = QuakeScan(
            archive, lut, onset=onset, run_path=str(root / "runs"),
            run_name=name, marginal_window=1.0, timestep=5.0, mesh=mesh,
            tile=64, fused_detect=True,
        )
        scan.detect("2021-02-18T12:00:20.0", "2021-02-18T12:00:40.0")
        return (
            root / "runs" / name / "detect" / "scanmseed"
            / "2021_049.scanmseed"
        )

    single = run("fused_single", None)
    sharded = run("fused_mesh", make_mesh(jax.devices()))

    from quakemigrate_tpu.seis import read

    st_single = read(str(single))
    st_sharded = read(str(sharded))
    for station in ("COA", "X", "Y", "Z"):
        a = st_single.select(station=station)[0].data
        b = st_sharded.select(station=station)[0].data
        np.testing.assert_array_equal(a, b, err_msg=station)
    # COA_N divides by the cross-shard psum (summation-order rounding)
    a = st_single.select(station="COA_N")[0].data.astype(np.int64)
    b = st_sharded.select(station="COA_N")[0].data.astype(np.int64)
    assert np.abs(a - b).max() <= 1
    assert (a != b).mean() < 0.05


def test_batched_mesh_detect_matches_single_device(setup):
    """detect_batch>1 under a 2-D batch x grid mesh: windows shard over
    the batch axis (one batched dispatch per group, inert pad windows)
    and the scanmseed must match the single-device serial run
    (round-4 verdict: the scan forced batch=1 under any mesh, giving up
    window pipelining multi-chip)."""

    root, archive, lut = setup

    def run(name, mesh, batch):
        onset = STALTAOnset(position="classic", sampling_rate=SPS)
        onset.phases = ["P", "S"]
        onset.bandpass_filters = {"P": [1, 12, 2], "S": [1, 12, 2]}
        onset.sta_lta_windows = {"P": [0.2, 1.0], "S": [0.2, 1.0]}
        scan = QuakeScan(
            archive, lut, onset=onset, run_path=str(root / "runs"),
            run_name=name, marginal_window=1.0, timestep=5.0, mesh=mesh,
            tile=64, fused_detect=True, detect_batch=batch,
        )
        scan.detect("2021-02-18T12:00:20.0", "2021-02-18T12:00:45.0")
        return (
            root / "runs" / name / "detect" / "scanmseed"
            / "2021_049.scanmseed"
        )

    single = run("bmesh_single", None, 1)
    # 2 x 4 mesh; detect_batch=3 rounds up to 4 (multiple of the batch
    # extent) and the 5-window span leaves a final partial batch -- both
    # pad paths exercised.
    mesh = make_mesh(jax.devices(), axis_names=("batch", "grid"),
                     shape=(2, 4))
    batched = run("bmesh_batched", mesh, 3)

    from quakemigrate_tpu.seis import read

    st_single = read(str(single))
    st_batched = read(str(batched))
    for station in ("COA", "X", "Y", "Z"):
        np.testing.assert_array_equal(
            st_single.select(station=station)[0].data,
            st_batched.select(station=station)[0].data,
            err_msg=station,
        )
    # COA_N divides by the cross-shard psum (summation-order rounding)
    a = st_single.select(station="COA_N")[0].data.astype(np.int64)
    b = st_batched.select(station="COA_N")[0].data.astype(np.int64)
    assert np.abs(a - b).max() <= 1
    assert (a != b).mean() < 0.05


def test_sharded_fused_op_matches_single_device_op():
    """Op-level: make_sharded_detect_fused == detect_window_fused."""

    from quakemigrate_tpu.ops.scan_window import detect_window_fused
    from quakemigrate_tpu.parallel import (
        make_sharded_detect_fused,
        pad_nodes_for_mesh,
    )

    rng = np.random.default_rng(3)
    n_slots, c_max, fsmp, nsamples, lsmp = 6, 3, 32, 100, 48
    t = fsmp + nsamples + lsmp
    channels = rng.normal(size=(n_slots, c_max, t)).astype(np.float32)
    chan_mask = np.ones((n_slots, c_max), dtype=np.float32)
    chan_mask[:3, 1:] = 0.0
    slot_mask = np.ones(n_slots, dtype=np.float32)
    slot_mask[4] = 0.0
    nsta = np.full(n_slots, 5, dtype=np.int32)
    nlta = np.full(n_slots, 21, dtype=np.int32)
    tt = rng.integers(0, lsmp, size=(500, n_slots)).astype(np.int32)

    ref = detect_window_fused(
        channels, chan_mask, slot_mask, nsta, nlta, tt,
        "classic", "energy", 0.5, fsmp, nsamples, tile=32,
    )

    mesh = make_mesh(jax.devices())
    tt_padded, n_real = pad_nodes_for_mesh(tt, mesh.shape["grid"], tile=32)
    fn = make_sharded_detect_fused(
        mesh, "classic", "energy", 0.5, fsmp, nsamples, n_real, tile=32,
    )
    out = fn(channels, chan_mask, slot_mask, nsta, nlta, tt_padded)

    np.testing.assert_array_equal(np.asarray(ref[0]), np.asarray(out[0]))
    np.testing.assert_array_equal(np.asarray(ref[2]), np.asarray(out[2]))
    np.testing.assert_allclose(
        np.asarray(ref[1]), np.asarray(out[1]), rtol=2e-6
    )


def test_fused_env_squared_matches_standard(setup):
    """The fused window's envelope transform path (as used by the VT
    example) matches the standard host-onset path."""

    root, archive, lut = setup

    def run(name, fused):
        onset = STALTAOnset(position="classic", sampling_rate=SPS,
                            signal_transform="env_squared")
        onset.phases = ["P", "S"]
        onset.bandpass_filters = {"P": [1, 12, 2], "S": [1, 12, 2]}
        onset.sta_lta_windows = {"P": [0.2, 1.0], "S": [0.2, 1.0]}
        scan = QuakeScan(
            archive, lut, onset=onset, run_path=str(root / "runs"),
            run_name=name, marginal_window=1.0, timestep=5.0, tile=64,
            fused_detect=fused, precision="double",
        )
        scan.detect("2021-02-18T12:00:20.0", "2021-02-18T12:00:40.0")
        return (
            root / "runs" / name / "detect" / "scanmseed"
            / "2021_049.scanmseed"
        )

    unfused = run("env_unfused", False)
    fused = run("env_fused", True)
    assert unfused.read_bytes() == fused.read_bytes()


def test_fused_kurtosis_mesh_matches_single(setup):
    """The fused kurtosis window sharded over the mesh == single device."""

    from quakemigrate_tpu.signal.onsets import KurtosisOnset

    root, archive, lut = setup

    def run(name, mesh):
        onset = KurtosisOnset(sampling_rate=SPS)
        onset.phases = ["P", "S"]
        onset.bandpass_filters = {"P": [1, 12, 2], "S": [1, 12, 2]}
        scan = QuakeScan(
            archive, lut, onset=onset, run_path=str(root / "runs"),
            run_name=name, marginal_window=1.0, timestep=5.0, mesh=mesh,
            tile=64, fused_detect=True,
        )
        scan.detect("2021-02-18T12:00:20.0", "2021-02-18T12:00:40.0")
        return (
            root / "runs" / name / "detect" / "scanmseed"
            / "2021_049.scanmseed"
        )

    single = run("kf_single", None)
    sharded = run("kf_mesh", make_mesh(jax.devices()))

    from quakemigrate_tpu.seis import read

    st_s = read(str(single))
    st_m = read(str(sharded))
    for station in ("COA", "X", "Y", "Z"):
        np.testing.assert_array_equal(
            st_s.select(station=station)[0].data,
            st_m.select(station=station)[0].data,
            err_msg=station,
        )
    a = st_s.select(station="COA_N")[0].data.astype(np.int64)
    b = st_m.select(station="COA_N")[0].data.astype(np.int64)
    assert np.abs(a - b).max() <= 1


def test_sharded_combine_matches_single_device_large_random():
    """
    The cross-shard max/argmax(psum-tie-break)/sum combine must reproduce
    the single-device result exactly on a large randomised grid — every
    sample's max value, winning node index and normalisation.

    """

    from quakemigrate_tpu.ops.migrate import migrate_detect
    from quakemigrate_tpu.parallel import (
        make_mesh,
        make_sharded_detect,
        pad_nodes_for_mesh,
    )

    rng = np.random.default_rng(1234)
    n_nodes, n_onsets = 196_608, 16
    fsmp, lsmp, nsamples = 100, 150, 200
    t_len = nsamples + fsmp + lsmp

    onsets = rng.gamma(2.0, 1.5, size=(n_onsets, t_len)).astype(np.float32)
    # Fully random traveltimes: adversarial for locality, and guarantees
    # argmax ties/structure are exercised across shard boundaries.
    tt = rng.integers(0, lsmp, size=(n_nodes, n_onsets), dtype=np.int32)
    mask = np.ones(n_onsets, dtype=np.float32)

    single = [
        np.asarray(a)
        for a in migrate_detect(
            onsets, tt, mask, float(n_onsets), fsmp, nsamples, tile=4096
        )
    ]

    mesh = make_mesh()
    n_shards = mesh.shape["grid"]
    tt_padded, _ = pad_nodes_for_mesh(tt, n_shards, tile=4096)
    sharded_fn = make_sharded_detect(mesh, fsmp, nsamples, n_nodes, tile=4096)
    sharded = [
        np.asarray(a)
        for a in sharded_fn(onsets, tt_padded, mask, float(n_onsets))
    ]

    np.testing.assert_allclose(sharded[0], single[0], rtol=1e-6)
    np.testing.assert_allclose(sharded[1], single[1], rtol=1e-6)
    # Winning node: identical flat index everywhere (first-wins tie-break)
    mismatches = np.flatnonzero(sharded[2] != single[2])
    assert mismatches.size == 0, (
        f"{mismatches.size} argmax mismatches, first {mismatches[:5]}"
    )


def test_mesh_kernel_cache_rekeys_on_geometry_change(setup):
    """
    Re-running detect with a different timestep on the SAME QuakeScan
    instance (mesh) must rebuild the sharded kernels for the new window
    geometry rather than reusing closures traced with the old static
    fsmp/nsamples (regression: caches were keyed on nothing).

    """

    root, archive, lut = setup

    from quakemigrate_tpu.io.core import Run

    def make_scan(name, timestep, fused):
        onset = STALTAOnset(position="classic", sampling_rate=SPS)
        onset.phases = ["P", "S"]
        onset.bandpass_filters = {"P": [1, 12, 2], "S": [1, 12, 2]}
        onset.sta_lta_windows = {"P": [0.2, 1.0], "S": [0.2, 1.0]}
        return QuakeScan(
            archive, lut, onset=onset, run_path=str(root / "runs"),
            run_name=name, marginal_window=1.0, timestep=timestep,
            mesh=make_mesh(jax.devices()), tile=64, fused_detect=fused,
        )

    span = ("2021-02-18T12:00:20.0", "2021-02-18T12:00:30.0")
    for fused in (False, True):
        tag = "f" if fused else "s"
        scan = make_scan(f"rekey_{tag}_a", 5.0, fused)
        scan.detect(*span)

        # Same instance, new window geometry (different fsmp/nsamples)
        scan.run = Run(str(root / "runs"), f"rekey_{tag}_b", "")
        scan.timestep = 2.5
        scan.detect(*span)

        fresh = make_scan(f"rekey_{tag}_c", 2.5, fused)
        fresh.detect(*span)

        got = (root / "runs" / f"rekey_{tag}_b" / "detect" / "scanmseed"
               / "2021_049.scanmseed")
        want = (root / "runs" / f"rekey_{tag}_c" / "detect" / "scanmseed"
                / "2021_049.scanmseed")
        assert got.read_bytes() == want.read_bytes(), f"fused={fused}"


def test_mesh_traveltime_table_is_sharded(setup):
    """With a mesh, the traveltime table is uploaded as one slab per
    "grid" device (whole tiles each); no device holds the whole table."""

    root, archive, lut = setup

    onset = STALTAOnset(position="classic", sampling_rate=SPS)
    onset.phases = ["P", "S"]
    mesh = make_mesh(jax.devices()[:4])
    scan = QuakeScan(
        archive, lut, onset=onset, run_path=str(root / "runs"),
        run_name="sharded_tt", marginal_window=1.0, timestep=5.0,
        mesh=mesh, tile=64,
    )
    scan._build_device_state()

    table = scan._device_tt
    shards = table.addressable_shards
    assert {s.device for s in shards} == set(mesh.devices.flat)
    rows = table.shape[0] // 4
    assert rows % 64 == 0 and rows * 4 >= scan._n_nodes
    for shard in shards:
        assert shard.data.shape == (rows, table.shape[1])


def test_mesh_locate_matches_single_device(setup, tmp_path):
    """locate() with a mesh must reproduce the single-device locations
    (the migration pass routes through the sharded kernel; the
    marginalisation pass and location estimators are per-event). Mesh
    coverage previously stopped at detect -- this pins the locate path."""

    root, archive, lut = setup

    # A trigger row at the planted event (wavelet zero time 12:00:30:
    # the simulate_waveforms default starttime + the 30 s half_timespan).
    trig_file = tmp_path / "trig.csv"
    pd.DataFrame([{
        "EventID": "20210218120030000",
        "CoaTime": "2021-02-18T12:00:30.0",
        "TRIG_COA": 2.0, "COA_X": 0.0, "COA_Y": 0.0, "COA_Z": 12.0,
        "COA": 2.0, "COA_NORM": 2.0,
    }]).to_csv(trig_file, index=False)

    def run(name, mesh):
        onset = STALTAOnset(position="centred", sampling_rate=SPS)
        onset.phases = ["P", "S"]
        onset.bandpass_filters = {"P": [1, 12, 2], "S": [1, 12, 2]}
        onset.sta_lta_windows = {"P": [0.2, 1.0], "S": [0.2, 1.0]}
        scan = QuakeScan(
            archive, lut, onset=onset, run_path=str(root / "runs"),
            run_name=name, marginal_window=1.0, mesh=mesh, tile=64,
            plot_event_summary=False,
        )
        scan.locate(trigger_file=str(trig_file))
        events = sorted(
            (root / "runs" / name / "locate" / "events").glob("*.event")
        )
        assert len(events) == 1, f"{name}: event not located"
        return pd.read_csv(events[0]).iloc[0]

    single = run("loc_single", None)
    sharded = run("loc_sharded", make_mesh(jax.devices()))

    assert sharded["DT"] == single["DT"]
    for col in ("X", "Y", "Z", "GAU_X", "GAU_Y", "GAU_Z", "COV_ErrX",
                "COV_ErrY", "COV_ErrZ"):
        assert sharded[col] == pytest.approx(single[col], abs=1e-6), col
    assert sharded["COA"] == pytest.approx(single["COA"], rel=1e-4)
