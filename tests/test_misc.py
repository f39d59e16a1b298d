# -*- coding: utf-8 -*-
"""
Coverage for smaller subsystems: NonLinLoc grid import, MFAST SAC export,
stream rotation, pick summary plotting, availability round trip.

"""

import struct

import numpy as np
import pandas as pd
import pytest

from quakemigrate_tpu.seis import Stream, Trace, UTCDateTime


def test_read_nlloc_roundtrip(tmp_path):
    """Write a synthetic NonLinLoc .hdr/.buf pair and import it."""

    from quakemigrate_tpu.lut.create import read_nlloc

    nx, ny, nz = 5, 4, 3
    x0, y0, z0 = -2.0, -1.5, 0.0
    dx = 1.0
    rng = np.random.default_rng(0)

    stations = pd.DataFrame(
        {"Name": ["AAA", "BBB"], "Latitude": [64.0, 64.1],
         "Longitude": [-17.0, -17.1], "Elevation": [0.0, 0.0]}
    )

    tables = {}
    for phase in ("P", "S"):
        for station in stations["Name"]:
            tt = rng.uniform(0.1, 5.0, size=(nx, ny, nz)).astype(np.float32)
            tables[(station, phase)] = tt
            stem = tmp_path / f"layer.{phase}.{station}.time"
            with open(f"{stem}.hdr", "w") as f:
                f.write(
                    f"{nx} {ny} {nz} {x0} {y0} {z0} {dx} {dx} {dx} TIME\n"
                )
                f.write(f"{station} 0.0 0.0 0.0\n")
                f.write(
                    "TRANSFORM LAMBERT RefEllipsoid WGS-84 LatOrig 64.05 "
                    "LongOrig -17.05 FirstStdParal 64.0 SecondStdParal 64.1 "
                    "RotCW 0.0\n"
                )
            with open(f"{stem}.buf", "wb") as f:
                f.write(struct.pack("f" * tt.size, *tt.ravel()))

    lut = read_nlloc(tmp_path, stations, phases=["P", "S"])
    assert tuple(lut.node_count) == (nx, ny, nz)
    for (station, phase), tt in tables.items():
        np.testing.assert_allclose(
            lut[station][phase], tt, rtol=1e-6
        )
    # Grid geometry restored (origin maps back to ll corner)
    assert lut.unit_name == "km"
    served = lut.serve_traveltimes(100)
    assert served.shape == (nx, ny, nz, 4)


def test_rotation_roundtrip():
    rng = np.random.default_rng(1)
    st = Stream()
    for comp, data in zip("ZNE", rng.normal(size=(3, 500))):
        st += Trace(
            data,
            {"station": "RT1", "channel": f"HH{comp}",
             "starttime": UTCDateTime(0), "sampling_rate": 100.0},
        )
    original = {tr.stats.channel: tr.data.copy() for tr in st}

    st.rotate("NE->RT", back_azimuth=37.0)
    # Non-participating components (Z) are kept, as in ObsPy
    assert {tr.stats.channel[-1] for tr in st} == {"R", "T", "Z"}
    np.testing.assert_array_equal(
        st.select(component="Z")[0].data, original["HHZ"]
    )
    st.rotate("RT->NE", back_azimuth=37.0)
    for tr in st:
        np.testing.assert_allclose(
            tr.data, original[tr.stats.channel], atol=1e-12
        )


def test_mfast_export(tmp_path):
    from quakemigrate_tpu.export import EventRecord, sac_mfast
    from quakemigrate_tpu.seis import read

    rng = np.random.default_rng(2)
    st = Stream()
    for comp in "ZNE":
        st += Trace(
            rng.normal(size=1000),
            {"station": "STA1", "channel": f"HH{comp}", "network": "XX",
             "starttime": UTCDateTime("2021-01-01T00:00:00"),
             "sampling_rate": 100.0},
        )
    wf_file = tmp_path / "event.m"
    st.write(str(wf_file), format="MSEED")

    picks = pd.DataFrame(
        {
            "Station": ["STA1", "STA1"],
            "Phase": ["P", "S"],
            "PickTime": ["2021-01-01T00:00:02.5", "2021-01-01T00:00:04.0"],
            "PickError": [0.02, 0.04],
        }
    )
    event = EventRecord(
        uid="testevent", otime=UTCDateTime("2021-01-01T00:00:01"),
        longitude=-17.0, latitude=64.0, depth_km=5.0, picks=picks,
    )
    stations = pd.DataFrame(
        {"Name": ["STA1"], "Latitude": [64.05], "Longitude": [-17.05],
         "Elevation": [0.5]}
    )
    sac_mfast(event, stations, tmp_path, "km", str(wf_file))

    sac_files = sorted((tmp_path / "testevent").glob("*"))
    assert len(sac_files) == 3
    st2 = read(str(sac_files[0]))
    assert st2[0].stats.station == "STA1"


def test_availability_roundtrip(tmp_path):
    from quakemigrate_tpu.io import Run, read_availability, write_availability

    run = Run(tmp_path, "avail_test")
    df = pd.DataFrame(
        {
            "S1_P": [1, 0, 1],
            "S1_S": [1, 1, 1],
        },
        index=[
            "2021-02-18T12:00:00.000000Z",
            "2021-02-18T12:00:10.000000Z",
            "2021-02-18T12:00:20.000000Z",
        ],
    )
    write_availability(run, df)
    out = read_availability(
        run, UTCDateTime("2021-02-18"), UTCDateTime("2021-02-19")
    )
    assert list(out.columns) == ["S1_P", "S1_S"]
    np.testing.assert_array_equal(out.values, df.values)


def test_pick_plot_renders(tmp_path):
    """GaussianPicker per-station pick figure renders without error."""

    import matplotlib

    matplotlib.use("Agg")

    from quakemigrate_tpu.io.event import Event
    from quakemigrate_tpu.plot.phase_picks import pick_summary

    rng = np.random.default_rng(3)
    waveforms = Stream()
    for comp in "ZNE":
        waveforms += Trace(
            rng.normal(size=2000),
            {"station": "PK1", "channel": f"HH{comp}",
             "starttime": UTCDateTime(0), "sampling_rate": 100.0},
        )
    onsets = {"P": 1 + np.abs(rng.normal(size=2000)),
              "S": 1 + np.abs(rng.normal(size=2000))}
    picks = pd.DataFrame(
        {
            "Station": ["PK1", "PK1"],
            "Phase": ["P", "S"],
            "ModelledTime": [UTCDateTime(5.0), UTCDateTime(9.0)],
            "PickTime": [UTCDateTime(5.1), -1],
            "PickError": [0.02, -1],
            "SNR": [12.0, -1],
            "Residual": [0.1, -1],
        }
    )
    windows = {"P": [400, 500, 600], "S": [800, 900, 1100]}

    event = Event(1.0, pd.Series({
        "EventID": "pltest", "CoaTime": UTCDateTime(5.0),
        "TRIG_COA": 2.0, "COA": 2.0, "COA_NORM": 2.2,
    }))
    event.picks["gaussfits"] = {
        "PK1": {"P": {"popt": [5.0, 5.0, 0.05],
                      "xdata": np.linspace(4.9, 5.3, 40),
                      "PickThreshold": 2.0},
                "S": {"popt": 0, "xdata": 0, "PickValue": -1,
                      "PickThreshold": 2.0}}
    }
    event.data = None

    fig = pick_summary(
        event, "PK1", waveforms, picks, onsets,
        {"P": "*Z", "S": "*[N,E]"}, [5.0, 5.1], windows,
    )
    fig.savefig(tmp_path / "picks.pdf")
    assert (tmp_path / "picks.pdf").stat().st_size > 1000


def test_deprecated_api_names(tmp_path, capsys):
    """Old reference scripts' parameter/class names keep working."""

    import numpy as np
    import pandas as pd

    from quakemigrate_tpu import QuakeScan, compute_traveltimes
    from quakemigrate_tpu.coords import Proj
    from quakemigrate_tpu.io import Archive
    from quakemigrate_tpu.signal.onsets import (
        CentredSTALTAOnset,
        ClassicSTALTAOnset,
    )

    onset = ClassicSTALTAOnset(position="centred", sampling_rate=50)
    assert onset.position == "classic"
    onset2 = CentredSTALTAOnset(sampling_rate=50)
    assert onset2.position == "centred"
    for o in (onset, onset2):
        o.phases = ["P", "S"]
        o.bandpass_filters = {"P": [1, 10, 2], "S": [1, 10, 2]}
        o.sta_lta_windows = {"P": [0.2, 1.0], "S": [0.2, 1.0]}

    stations = pd.DataFrame(
        {"Name": ["A"], "Longitude": [0.01], "Latitude": [0.01],
         "Elevation": [0.0]}
    )
    lut = compute_traveltimes(
        dict(
            ll_corner=[-0.05, -0.05, 0.0], ur_corner=[0.05, 0.05, 10.0],
            node_spacing=[5.0, 5.0, 5.0],
            grid_proj=Proj(proj="tmerc", units="km", lon_0=0.0, lat_0=0.0),
            coord_proj=Proj(proj="longlat"),
        ),
        stations, method="homogeneous", phases=["P", "S"], vp=5.0, vs=3.0,
    )
    archive = Archive(archive_path=tmp_path, stations=stations)

    scan = QuakeScan(
        archive, lut, onset=onset, run_path=str(tmp_path / "runs"),
        run_name="dep", time_step=7.5, n_cores=4, sampling_rate=50,
    )
    out = capsys.readouterr().out
    assert scan.timestep == 7.5
    assert scan.time_step == 7.5
    assert scan.threads == 4
    assert scan.n_cores == 4
    assert scan.sampling_rate == 50
    assert "time_step" in out and "n_cores" in out


def test_old_format_availability(tmp_path):
    """Old availability files (one column per station) convert on read."""

    import pandas as pd

    from quakemigrate_tpu.io.availability import (
        read_availability,
        write_availability,
    )
    from quakemigrate_tpu.io.core import Run
    from quakemigrate_tpu.seis import UTCDateTime

    run = Run(str(tmp_path), "oldfmt")
    fpath = run.path / "detect" / "availability"
    fpath.mkdir(parents=True)
    old = pd.DataFrame(
        {"ST01": [1, 0], "ST02": [1, 1]},
        index=["2021-02-18T12:00:00.0", "2021-02-18T12:02:00.0"],
    )
    old.to_csv(fpath / "2021_049_StationAvailability.csv")

    table = read_availability(
        run, UTCDateTime("2021-02-18T12:00:00"),
        UTCDateTime("2021-02-18T12:05:00"),
    )
    assert sorted(table.columns) == ["ST01_P", "ST01_S", "ST02_P", "ST02_S"]
    assert table["ST01_P"].tolist() == [1, 0]
    assert table["ST02_S"].tolist() == [1, 1]

    # New-format roundtrip still untouched by the converter
    write_availability(run, table)
    table2 = read_availability(
        run, UTCDateTime("2021-02-18T12:00:00"),
        UTCDateTime("2021-02-18T12:05:00"),
    )
    assert sorted(table2.columns) == sorted(table.columns)


def test_option_defaults_not_shared_between_instances():
    """Mutable defaults (dicts in the class-level tables) must be copied
    per instance — mutating one object cannot leak into the next."""

    from quakemigrate_tpu.signal.local_mag.magnitude import Magnitude
    from quakemigrate_tpu.signal.onsets import STALTAOnset

    first = STALTAOnset(sampling_rate=100)
    first.sta_lta_windows["P"] = [9.9, 99.9]
    first.bandpass_filters["S"][0] = -1
    second = STALTAOnset(sampling_rate=100)
    assert second.sta_lta_windows["P"] == [0.2, 1.0]
    assert second.bandpass_filters["S"][0] == 2.0

    m1 = Magnitude({"A0": "keir2006"})
    m1.station_corrections["NET.STA..HHZ"] = 0.5
    assert Magnitude({"A0": "keir2006"}).station_corrections == {}


def test_event_write_metre_grid_integer_depths(tmp_path):
    """
    Metre-unit grids round depth columns to whole metres and cast them to
    int (ref event.py:477-505's unit_correction branch) — exercised here
    since the benchmark grids are all km-unit.

    """

    from types import SimpleNamespace

    from quakemigrate_tpu.io.event import Event
    from quakemigrate_tpu.seis import UTCDateTime

    run = SimpleNamespace(path=tmp_path, subname="")
    lut = SimpleNamespace(precision=[-2, -2, -2], unit_name="m")

    event = Event(1.0, {"EventID": "20200101000000000",
                        "CoaTime": UTCDateTime("2020-01-01T00:00:00"),
                        "TRIG_COA": 1.5, "COA": 1.4, "COA_NORM": 1.3})
    event.add_compute_output(
        np.array([UTCDateTime("2020-01-01T00:00:00")], dtype=object),
        np.array([1.9]), np.array([1.7]),
        np.array([[10.12345678, 20.12345678, 1234.5678]]),
        None, None,
    )
    event.add_spline_location([10.12345678, 20.12345678, 1234.5678])
    event.add_gaussian_location(
        [10.1, 20.1, 1230.4], [120.456, 130.456, 140.456]
    )
    event.add_covariance_location(
        [10.2, 20.2, 1231.6], [150.456, 160.456, 170.456]
    )
    event.write(run, lut)

    out = pd.read_csv(tmp_path / "locate" / "events" / f"{event.uid}.event")
    row = out.iloc[0]
    # Depth and every uncertainty column are whole metres (ints)
    for col in ("Z", "GAU_Z", "GAU_ErrX", "GAU_ErrY", "GAU_ErrZ",
                "COV_ErrX", "COV_ErrY", "COV_ErrZ", "COV_Err_XYZ"):
        assert float(row[col]) == int(row[col]), col
    assert int(row["Z"]) == 1235  # rounded, not truncated
    # X/Y keep at least 6 decimals
    assert abs(row["X"] - 10.123457) < 5e-7


def test_event_mw_times_rounding_and_count():
    """
    mw_times must round (not truncate) 4*mw*rate -- truncation disagrees
    with the scan window's own nearest-sample rounding for combos like
    mw=2.3 @ 50 Hz (4*2.3*50 = 459.99999999999994) -- and an explicit
    ``count`` must pin the length to the migration window exactly.

    """

    from quakemigrate_tpu.io.event import Event

    ev = Event(marginal_window=2.3)
    ev.trigger_time = UTCDateTime("2021-01-01T00:00:10.0")

    times = ev.mw_times(50.0)
    assert len(times) == 461  # round(459.99999...) + 1
    assert times[0] == ev.trigger_time - 4.6
    assert abs((times[-1] - times[0]) - 9.2) < 1e-9

    assert len(ev.mw_times(50.0, count=123)) == 123


def test_availability_underscore_station_names(tmp_path):
    """Stations whose names contain underscores survive the availability
    new/old format detection and LUT key splitting (regression:
    split('_') misparsed 'ST_01_P')."""

    from types import SimpleNamespace

    from quakemigrate_tpu.io.availability import _read_one_day

    # New-format file with an underscore station: must NOT be treated as
    # old-format
    new = tmp_path / "new.csv"
    pd.DataFrame(
        {"ST_01_P": [1], "ST_01_S": [0]}, index=["2021-01-01T00:00:00"]
    ).to_csv(new)
    table = _read_one_day(new)
    assert list(table.columns) == ["ST_01_P", "ST_01_S"]

    # Old-format file (plain station columns, underscore in the name)
    old = tmp_path / "old.csv"
    pd.DataFrame({"ST_01": [1]}, index=["2021-01-01T00:00:00"]).to_csv(old)
    table = _read_one_day(old)
    assert sorted(table.columns) == ["ST_01_P", "ST_01_S"]

    # Old-format file whose station names all end in a two-letter
    # alphabetic suffix (e.g. compass directions) must still be expanded
    # (regression: a <=2-letter suffix test misread these as new-format)
    compass = tmp_path / "compass.csv"
    pd.DataFrame(
        {"ST_NE": [1], "ST_SW": [0]}, index=["2021-01-01T00:00:00"]
    ).to_csv(compass)
    table = _read_one_day(compass)
    assert sorted(table.columns) == [
        "ST_NE_P", "ST_NE_S", "ST_SW_P", "ST_SW_S"
    ]

    # A marker-bearing file (index named DT, as written by this package)
    # is new-format regardless of column naming.
    marked = tmp_path / "marked.csv"
    pd.DataFrame(
        {"ST_NE": [1]}, index=pd.Index(["2021-01-01T00:00:00"], name="DT")
    ).to_csv(marked)
    assert list(_read_one_day(marked).columns) == ["ST_NE"]


def test_lut_serve_traveltimes_underscore_station():
    """serve_traveltimes availability masking rsplits keys so underscore
    station names resolve (regression)."""

    from quakemigrate_tpu import compute_traveltimes
    from quakemigrate_tpu.coords import Proj

    gproj = Proj(proj="tmerc", units="km", lon_0=0.0, lat_0=0.0)
    grid_spec = dict(
        ll_corner=[-0.02, -0.02, 0.0], ur_corner=[0.02, 0.02, 5.0],
        node_spacing=[2.0, 2.0, 2.0], grid_proj=gproj,
        coord_proj=Proj(proj="longlat"),
    )
    stations = pd.DataFrame(
        {"Name": ["ST_01", "B"], "Longitude": [0.01, -0.01],
         "Latitude": [0.01, -0.01], "Elevation": [0.0, 0.0]}
    )
    lut = compute_traveltimes(
        grid_spec, stations, method="homogeneous", phases=["P"], vp=5.0,
        vs=3.0,
    )
    tt = lut.serve_traveltimes(50, {"ST_01_P": 1, "B_P": 1})
    assert tt.shape[-1] == 2


def test_event_write_nan_uncertainty_metre_grid(tmp_path):
    """A degenerate uncertainty fit (NaN) must not kill the .event write
    on metre grids where columns are cast to int (regression)."""

    from types import SimpleNamespace

    from quakemigrate_tpu.io.event import Event

    run = SimpleNamespace(path=tmp_path, subname="")
    lut = SimpleNamespace(precision=[-2, -2, -2], unit_name="m")

    event = Event(1.0, {"EventID": "20200101000001000",
                        "CoaTime": UTCDateTime("2020-01-01T00:00:01"),
                        "TRIG_COA": 1.5, "COA": 1.4, "COA_NORM": 1.3})
    event.add_compute_output(
        np.array([UTCDateTime("2020-01-01T00:00:01")], dtype=object),
        np.array([1.9]), np.array([1.7]),
        np.array([[10.1, 20.1, 1234.6]]),
        None, None,
    )
    event.add_spline_location([10.1, 20.1, 1234.6])
    event.add_gaussian_location([10.1, 20.1, 1230.4],
                                [np.nan, np.nan, np.nan])
    event.add_covariance_location([10.2, 20.2, 1231.6],
                                  [150.456, np.nan, 170.456])
    event.write(run, lut)

    out = pd.read_csv(tmp_path / "locate" / "events" / f"{event.uid}.event")
    row = out.iloc[0]
    assert int(row["Z"]) == 1235
    assert np.isnan(row["GAU_ErrX"])
    assert int(row["COV_ErrX"]) == 150


def test_snuffler_marker_microsecond_padding(tmp_path):
    """Marker fractional seconds zero-pad microseconds (regression:
    1234 us rendered as '.1234' = 0.1234 s)."""

    from quakemigrate_tpu.export import EventRecord, snuffler_markers

    picks = pd.DataFrame(
        {
            "Station": ["STA1"],
            "Phase": ["P"],
            "PickTime": ["2021-01-01T12:00:00.001234"],
            "PickError": [0.02],
        }
    )
    event = EventRecord(
        uid="padev", otime=UTCDateTime("2021-01-01T12:00:00.001234"),
        longitude=-17.0, latitude=64.0, depth_km=5.0, picks=picks,
    )
    snuffler_markers(event, tmp_path)
    text = (tmp_path / "padev" / "padev.markers").read_text()
    assert "12:00:00.001234" in text
    assert "12:00:00.1234" not in text


def test_mfast_skips_stations_without_s_pick(tmp_path):
    """Stations whose S pick failed are excluded from the MFAST export
    (regression: t0=0.0 was written, pointing MFAST at noise)."""

    from quakemigrate_tpu.export import EventRecord, sac_mfast
    from quakemigrate_tpu.seis import read as seis_read

    rng = np.random.default_rng(3)
    st = Stream()
    for comp in "ZNE":
        st += Trace(
            rng.normal(size=500),
            {"station": "NOS", "channel": f"HH{comp}", "network": "XX",
             "starttime": UTCDateTime("2021-01-01T00:00:00"),
             "sampling_rate": 100.0},
        )
    wf_file = tmp_path / "event.m"
    st.write(str(wf_file), format="MSEED")

    picks = pd.DataFrame(
        {
            "Station": ["NOS", "NOS"],
            "Phase": ["P", "S"],
            "PickTime": ["2021-01-01T00:00:01.0", "-1"],
            "PickError": [0.02, -1],
        }
    )
    event = EventRecord(
        uid="nosev", otime=UTCDateTime("2021-01-01T00:00:00.5"),
        longitude=-17.0, latitude=64.0, depth_km=5.0, picks=picks,
    )
    stations = pd.DataFrame(
        {"Name": ["NOS"], "Latitude": [64.05], "Longitude": [-17.05],
         "Elevation": [0.5]}
    )
    sac_mfast(event, stations, tmp_path, "km", str(wf_file))
    assert not list((tmp_path / "nosev").glob("*"))


def test_catalog_read_run_validates_units(tmp_path):
    """read_run rejects unknown units instead of silently scaling depths
    by 1/1000 (regression)."""

    from quakemigrate_tpu.export import read_run

    with pytest.raises(AttributeError):
        read_run(tmp_path, units="KM")


def test_read_nlloc_node_count_matches_header(tmp_path):
    """
    The corner round-trip through geographic coordinates can land ~1e-13
    above an exact spacing multiple, inflating the derived node count by
    one vs the traveltime arrays (regression): the .hdr count is
    authoritative.

    """

    import struct

    from quakemigrate_tpu.lut.create import read_nlloc

    # A LAMBERT geometry empirically shown to overcount pre-fix
    nx, ny, nz = 37, 101, 30
    x0, y0, z0 = -47.95132380319026, -49.17361822357355, 0.0
    dx, dz = 1.0, 0.5
    lat0, lon0 = 49.10885061964363, -13.81279717416778
    rng = np.random.default_rng(5)

    stations = pd.DataFrame(
        {"Name": ["CCC"], "Latitude": [lat0], "Longitude": [lon0],
         "Elevation": [0.0]}
    )

    tt = rng.uniform(0.1, 5.0, size=(nx, ny, nz)).astype(np.float32)
    stem = tmp_path / "layer.P.CCC.time"
    with open(f"{stem}.hdr", "w") as f:
        f.write(f"{nx} {ny} {nz} {x0} {y0} {z0} {dx} {dx} {dz} TIME\n")
        f.write("CCC 0.0 0.0 0.0\n")
        f.write(
            f"TRANSFORM LAMBERT RefEllipsoid WGS-84 LatOrig {lat0} "
            f"LongOrig {lon0} FirstStdParal {lat0 - 2} "
            f"SecondStdParal {lat0 + 2} RotCW 0.0\n"
        )
    with open(f"{stem}.buf", "wb") as f:
        f.write(struct.pack("f" * tt.size, *tt.ravel()))

    lut = read_nlloc(tmp_path, stations, phases=["P"])
    assert tuple(lut.node_count) == (nx, ny, nz)
    # traveltime_to interpolates on axes sized from node_count: must not
    # raise a shape mismatch
    val = lut.traveltime_to("P", [[1, 1, 1]], "CCC")
    assert np.isfinite(val).all()


def test_event_summary_slice_orientation():
    """
    Map cross-sections feed lut_plot with axis 0 -> panel x: for a map of
    distinct dims (nx, ny, nz) the xy slice must be (nx, ny), xz
    (nx, nz) and yz (nz, ny) (regression: all three were transposed,
    mirroring the coalescence blob across the panel diagonal).

    """

    from quakemigrate_tpu.plot.event import _map_slices

    nx, ny, nz = 5, 7, 3
    coa_map = np.arange(nx * ny * nz, dtype=float).reshape(nx, ny, nz)
    xy, xz, yz = _map_slices(coa_map, (1, 2, 0))
    assert xy.shape == (nx, ny)
    assert xz.shape == (nx, nz)
    assert yz.shape == (nz, ny)
    np.testing.assert_array_equal(xy, coa_map[:, :, 0])
    np.testing.assert_array_equal(xz, coa_map[:, 2, :])
    np.testing.assert_array_equal(yz, coa_map[1, :, :].T)


def test_scan_rate_assignment_refused(tmp_path, capsys):
    """scan_rate is pinned to the onset sampling rate: a user assignment
    must not silently break the traveltime quantisation (regression)."""

    from quakemigrate_tpu import QuakeScan, compute_traveltimes
    from quakemigrate_tpu.coords import Proj
    from quakemigrate_tpu.io import Archive
    from quakemigrate_tpu.signal.onsets import STALTAOnset

    gproj = Proj(proj="tmerc", units="km", lon_0=0.0, lat_0=0.0)
    grid_spec = dict(
        ll_corner=[-0.02, -0.02, 0.0], ur_corner=[0.02, 0.02, 5.0],
        node_spacing=[2.0, 2.0, 2.0], grid_proj=gproj,
        coord_proj=Proj(proj="longlat"),
    )
    stations = pd.DataFrame(
        {"Name": ["A"], "Longitude": [0.01], "Latitude": [0.01],
         "Elevation": [0.0]}
    )
    lut = compute_traveltimes(
        grid_spec, stations, method="homogeneous", phases=["P"], vp=5.0,
        vs=3.0,
    )
    onset = STALTAOnset(position="classic", sampling_rate=50.0)
    archive = Archive(archive_path=tmp_path, stations=stations,
                      archive_format="YEAR/JD/STATION")
    scan = QuakeScan(archive, lut, onset=onset, run_path=str(tmp_path),
                     run_name="rate")
    assert scan.scan_rate == 50.0
    scan.scan_rate = 100.0
    assert scan.scan_rate == 50.0
    assert "fixed to the onset" in capsys.readouterr().out


def test_amplitude_rejects_moved_response_params():
    """Deprecated response-removal parameters in amp_params raise instead
    of being silently ignored (regression)."""

    from quakemigrate_tpu.signal.local_mag.amplitude import Amplitude

    with pytest.raises(AttributeError, match="moved to"):
        Amplitude({"signal_window": 5.0, "water_level": 30})
    Amplitude({"signal_window": 5.0})  # clean params still fine


def test_event_trigger_fields_coa_v_fallback():
    """Old-format trigger rows (COA_V peak column) carry their value into
    TRIG_COA instead of becoming NaN (regression)."""

    from quakemigrate_tpu.io.event import Event

    old_row = pd.Series({
        "EventID": "x", "CoaTime": UTCDateTime("2020-01-01"),
        "COA_V": 3.5, "COA": 3.1, "COA_NORM": 2.9,
    })
    ev = Event(1.0, old_row)
    assert ev.trigger_info["TRIG_COA"] == 3.5
    assert ev.trigger_info["DEC_COA"] == 3.1

    oldest_row = pd.Series({
        "EventID": "y", "CoaTime": UTCDateTime("2020-01-01"),
        "COA_V": 2.5,
    })
    ev2 = Event(1.0, oldest_row)
    assert ev2.trigger_info["TRIG_COA"] == 2.5
    assert np.isnan(ev2.trigger_info["DEC_COA"])


def test_quakeml_structural_validity(tmp_path):
    """QuakeML output carries the schema-required networkCode, omits NaN
    uncertainties (not valid xs:double), and describes a lone
    horizontalUncertainty correctly (regression)."""

    import xml.etree.ElementTree as ET

    from quakemigrate_tpu.export import EventRecord
    from quakemigrate_tpu.export.to_quakeml import _NS, _QNS, _SMI, _event_xml

    picks = pd.DataFrame(
        {
            "Station": ["STA1"],
            "Phase": ["P"],
            "PickTime": [UTCDateTime("2021-01-01T00:00:02.5")],
            "PickError": [0.02],
        }
    )
    rec = EventRecord(
        uid="qml1", otime=UTCDateTime("2021-01-01T00:00:01"),
        longitude=-17.0, latitude=64.0, depth_km=5.0, picks=picks,
        err_x_km=0.2, err_y_km=0.3, err_z_km=np.nan,
        cov_err_xyz_km=0.4, ml=1.2, ml_err=np.nan,
    )
    out = tmp_path / "cat.xml"
    out.write_text("\n".join([
        '<?xml version="1.0" encoding="UTF-8"?>',
        f'<q:quakeml xmlns:q="{_QNS}" xmlns="{_NS}">',
        f'  <eventParameters publicID="{_SMI}/catalog">',
        _event_xml(rec),
        "  </eventParameters>", "</q:quakeml>", "",
    ]))
    text = out.read_text()
    assert "nan" not in text.lower().replace("quakeml", "")
    root = ET.parse(str(out)).getroot()

    ns = {"q": root.tag.split("}")[0].strip("{")} if "}" in root.tag else {}
    wid = root.find(".//waveformID") if not ns else root.find(
        ".//q:waveformID", ns
    )
    # Fall back to tag scan if namespacing differs
    found = [e for e in root.iter() if e.tag.endswith("waveformID")]
    assert found and "networkCode" in found[0].attrib

    descs = [e.text for e in root.iter()
             if e.tag.endswith("preferredDescription")]
    assert descs == ["horizontal uncertainty"]


@pytest.mark.parametrize("env, arg, want", [
    ("env", None, "env"),       # $JAX_COMPILATION_CACHE_DIR is used...
    ("env", "arg", "env"),      # ...and wins over an explicit directory
    (None, "arg", "arg"),       # unset: the explicit directory
    (None, None, "default"),    # unset, no argument: inside the checkout
])
def test_enable_compilation_cache(tmp_path, monkeypatch, env, arg, want):
    """Compile-cache resolution: the environment variable always wins;
    otherwise an explicit directory, otherwise the fixed directory inside
    the checkout (which .gitignore lists)."""

    import jax

    from quakemigrate_tpu import util

    dirs = {"env": tmp_path / "env", "arg": tmp_path / "arg"}
    default = tmp_path / "checkout" / ".jax_cache"
    monkeypatch.setattr(util, "DEFAULT_COMPILATION_CACHE_DIR", default)
    dirs["default"] = default
    if env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(dirs[env]))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)

    prior = jax.config.jax_compilation_cache_dir
    try:
        got = util.enable_compilation_cache(dirs.get(arg))
        assert got == str(dirs[want])
        assert jax.config.jax_compilation_cache_dir == str(dirs[want])
        assert dirs[want].is_dir()
        assert not any(d.exists() for k, d in dirs.items() if k != want)
    finally:
        jax.config.update("jax_compilation_cache_dir", prior)


def test_default_compilation_cache_is_ignored_checkout_dir():
    """The default cache directory sits inside the checkout and is listed
    in .gitignore, so nothing is written around the checkout."""

    import pathlib

    from quakemigrate_tpu import util

    root = pathlib.Path(util.__file__).resolve().parent.parent
    cache = util.DEFAULT_COMPILATION_CACHE_DIR
    assert cache.parent == root
    ignored = (root / ".gitignore").read_text().split()
    assert f"{cache.name}/" in ignored


def test_scan_compilation_cache_option(tmp_path, monkeypatch):
    """QuakeScan(compilation_cache=<path>) routes through the helper;
    =False leaves jax config untouched."""

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)

    import jax
    import numpy as np
    import pandas as pd

    from quakemigrate_tpu import QuakeScan, compute_traveltimes
    from quakemigrate_tpu.coords import Proj
    from quakemigrate_tpu.io import Archive
    from quakemigrate_tpu.signal.onsets import STALTAOnset

    stations = pd.DataFrame({
        "Name": ["S0", "S1"], "Longitude": [0.0, 0.01],
        "Latitude": [0.01, 0.0], "Elevation": [0.0, 0.0],
    })
    lut = compute_traveltimes(
        dict(ll_corner=[-0.02, -0.02, 0.0], ur_corner=[0.02, 0.02, 4.0],
             node_spacing=[2.0, 2.0, 2.0],
             grid_proj=Proj(proj="tmerc", units="km", lon_0=0.0, lat_0=0.0),
             coord_proj=Proj(proj="longlat")),
        stations, method="homogeneous", phases=["P", "S"], vp=5.0, vs=3.0,
    )
    onset = STALTAOnset(position="classic", sampling_rate=50)
    onset.phases = ["P", "S"]
    onset.bandpass_filters = {"P": [1, 12, 2], "S": [1, 12, 2]}
    onset.sta_lta_windows = {"P": [0.2, 1.0], "S": [0.2, 1.0]}
    archive = Archive(
        archive_path=tmp_path, stations=stations,
        archive_format="YEAR/JD/STATION",
    )

    def scan(**kw):
        return QuakeScan(
            archive, lut, onset=onset, run_path=str(tmp_path / "runs"),
            run_name="cc", **kw,
        )

    prior = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        scan(compilation_cache=False)
        assert jax.config.jax_compilation_cache_dir is None
        cdir = tmp_path / "cache"
        scan(compilation_cache=str(cdir))
        assert jax.config.jax_compilation_cache_dir == str(cdir)
        assert cdir.is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", prior)


def test_gaufilt3d_matches_reference_double_fftconvolve():
    """The separable truncated implementation is numerically identical
    (fp noise) to the reference's two full-grid-kernel fftconvolves with
    inter-pass flips (ref scan.py:1007-1043), including the even-axis
    centre conventions the flips imply."""

    import numpy as np
    from scipy.signal import fftconvolve
    from types import SimpleNamespace

    import quakemigrate_tpu.util as util
    from quakemigrate_tpu.signal.scan import QuakeScan

    rng = np.random.default_rng(3)
    scan = QuakeScan.__new__(QuakeScan)
    for dims in ((24, 16, 13), (17, 15, 11)):
        m = rng.random(dims)
        m[dims[0] // 2, dims[1] // 2, dims[2] // 2] = 4.0
        m = m / m.max()

        flt = util.gaussian_3d(*dims, 0.8)
        ref = fftconvolve(m, flt, mode="same")
        ref = ref[::-1, ::-1, ::-1] / np.nanmax(ref)
        ref = fftconvolve(ref, flt, mode="same")
        ref = ref[::-1, ::-1, ::-1] / np.nanmax(ref)

        got = scan._gaufilt3d(m.copy())
        assert np.abs(got - ref).max() < 1e-12


def test_covfit3d_matches_full_grid_formulation():
    """The indexed covariance fit matches the full-grid nansum-over-masked-
    lattice formulation (the pre-optimisation form, itself mirroring ref
    scan.py's weighted-moment fit) on random maps with NaN holes."""

    import numpy as np
    from types import SimpleNamespace

    from quakemigrate_tpu.signal.scan import QuakeScan

    rng = np.random.default_rng(7)
    shape = (14, 11, 9)
    spacing = np.array([0.5, 0.4, 0.25])
    scan = QuakeScan.__new__(QuakeScan)
    scan.lut = SimpleNamespace(
        node_count=np.array(shape),
        node_spacing=spacing,
        ll_corner=np.array([3.0, -2.0, 1.0]),
        coord2grid=lambda xyz, inverse=False: np.atleast_2d(xyz),
    )

    def oracle(coa_map, thresh):
        keep = coa_map > thresh
        weights = np.where(keep.ravel(), coa_map.ravel(), np.nan)
        total = np.nansum(weights)
        lattice = np.meshgrid(*[np.arange(n) for n in shape], indexing="ij")
        positions = [g.ravel() * s for g, s in zip(lattice, spacing)]
        mean = [np.nansum(weights * axis) / total for axis in positions]
        deviations = [axis - m for axis, m in zip(positions, mean)]
        cov = np.empty((3, 3))
        for r in range(3):
            for c in range(r, 3):
                cov[r, c] = cov[c, r] = (
                    np.nansum(weights * deviations[r] * deviations[c]) / total
                )
        loc = scan.lut.ll_corner + np.array(mean)
        return loc, np.diag(np.sqrt(abs(cov)))

    for thresh in (0.9, 0.5):
        m = rng.random(shape)
        m[rng.random(shape) < 0.1] = np.nan  # NaN holes never pass >thresh
        m[7, 5, 4] = 1.0
        want_loc, want_err = oracle(m, thresh)
        got_loc, got_err = scan._covfit3d(m.copy(), thresh=thresh)
        np.testing.assert_allclose(np.asarray(got_loc).ravel(), want_loc,
                                   rtol=1e-12)
        np.testing.assert_allclose(got_err, want_err, rtol=1e-12)


def test_scan_option_and_span_validation(tmp_path):
    """Unknown keyword options (among them the removed ``kernel`` and
    ``mxu_encoding``) are ignored, as the reference ignores them: they set
    no attribute and select nothing. One-sided locate spans raise the
    documented RuntimeError (not a UTCDateTime TypeError); zero-length
    detect spans raise TimeSpanException up front (not an IndexError at
    the empty scanmseed write)."""

    from types import SimpleNamespace

    import pytest

    import quakemigrate_tpu.util as util
    from quakemigrate_tpu.signal.onsets import STALTAOnset
    from quakemigrate_tpu.signal.scan import QuakeScan

    onset = STALTAOnset(phases=["P"], sampling_rate=50)
    lut = SimpleNamespace(max_traveltime=1.0)
    scan = QuakeScan("arc", lut, onset=onset, run_path=tmp_path,
                     run_name="t", kernel="mxu", mxu_encoding="i8x2",
                     no_such_option=1)
    for name in ("kernel", "mxu_encoding", "no_such_option"):
        assert not hasattr(scan, name)

    onset = STALTAOnset(phases=["P"], sampling_rate=50)
    scan = QuakeScan("arc", lut, onset=onset, run_path=tmp_path,
                     run_name="t")
    with pytest.raises(RuntimeError, match="AND an endtime"):
        scan.locate(starttime="2021-01-01T00:00:00")
    with pytest.raises(util.TimeSpanException):
        scan.detect("2021-01-01T06:00:00", "2021-01-01T06:00:00")


def test_plot_xy_files_overlay(tmp_path, caplog):
    """XY overlay files (spec CSV -> per-file lon/lat polylines) draw one
    line per well-formed row and skip malformed/missing entries with a
    warning (reference xy_files convention, ref signal/scan.py:92-96)."""

    import logging as _logging

    import matplotlib.pyplot as plt
    import numpy as np

    from quakemigrate_tpu.plot.xy import plot_xy_files

    coast = tmp_path / "coast.xy"
    coast.write_text("# lon,lat\n-17.1,64.1\n-17.2,64.2\n-17.3,64.15\n")
    fault = tmp_path / "fault.xy"
    fault.write_text("-17.25,64.05\n-17.05,64.3\n")
    spec = tmp_path / "xy_files.csv"
    spec.write_text(
        f"{coast},k,0.5,-\n"
        f"{fault},r,1.0,--\n"
        f"{tmp_path / 'missing.xy'},b,1.0,-\n"   # unresolvable -> warn
        "malformed_row_only_one_field\n"          # short row -> warn
    )

    fig, ax = plt.subplots()
    with caplog.at_level(_logging.WARNING):
        plot_xy_files(spec, ax)
    assert len(ax.lines) == 2
    np.testing.assert_allclose(ax.lines[0].get_xdata(),
                               [-17.1, -17.2, -17.3])
    assert ax.lines[1].get_linestyle() == "--"
    assert sum("Skipping malformed" in r.message for r in caplog.records) == 1
    plt.close(fig)

    # None is a no-op (the default)
    fig, ax = plt.subplots()
    plot_xy_files(None, ax)
    assert len(ax.lines) == 0
    plt.close(fig)
