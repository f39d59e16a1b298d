# -*- coding: utf-8 -*-
"""
Volcanotectonic_Iceland locate parity on real data: the reference built
its traveltime tables with the external NonLinLoc Grid2Time solver; here
the native "1dsweep" fast-marching builder replaces it, so this test
checks that locations agree with the golden outputs to within the velocity
-model-equivalence tolerance (~1-2 grid nodes) rather than exactly.
Magnitudes are compared structurally against the golden .amps/.event files
using a generated response inventory (see test_vt_amplitude_structural_parity
/ test_vt_network_ml_parity): the true Z7 instrument gains are not bundled,
so amplitudes/ML match up to one constant, while measurement times, filter
gains and magnitude uncertainties match absolutely.

"""

import shutil

import numpy as np
import pandas as pd
import pytest

from quakemigrate_tpu import QuakeScan, compute_traveltimes
from quakemigrate_tpu.coords import Proj
from quakemigrate_tpu.io import (
    Archive,
    read_response_inv,
    read_stations,
    read_vmodel,
)
from quakemigrate_tpu.seis import UTCDateTime
from quakemigrate_tpu.signal.local_mag import LocalMag
from quakemigrate_tpu.signal.onsets import STALTAOnset

from oracle import REFERENCE_PATH

BENCH = REFERENCE_PATH / "examples" / "benchmarks" / "Volcanotectonic_Iceland"
INPUTS = REFERENCE_PATH / "examples" / "Volcanotectonic_Iceland" / "inputs"

pytestmark = pytest.mark.skipif(
    not BENCH.exists(), reason="reference benchmark files unavailable"
)

NODE_SPACING = 0.5  # km

# The Z7 (Cambridge Iceland) instrument responses are not bundled with the
# reference benchmark (the reference CI downloads them from IRIS). The
# stations ran broadband velocity sensors that are flat across the 2-20 Hz
# measurement band, so a generated inventory with a generic 30 s velocity
# PAZ reproduces the amplitude *measurement chain* exactly, up to one
# unknown gain per station -- the structural-parity tests below compare
# measurement times/frequencies/filter gains absolutely, and amplitudes/ML
# up to a per-station constant offset.
_STATIONXML_HEAD = """<?xml version="1.0" encoding="UTF-8"?>
<FDSNStationXML xmlns="http://www.fdsn.org/xml/station/1" schemaVersion="1.1">
  <Source>quakemigrate_tpu-tests</Source>
  <Created>2021-01-01T00:00:00</Created>
  <Network code="Z7">
{stations}
  </Network>
</FDSNStationXML>
"""

_CHANNEL_BLOCK = """
      <Channel code="HH{comp}" locationCode="" startDate="2013-01-01T00:00:00">
        <Latitude>{lat}</Latitude>
        <Longitude>{lon}</Longitude>
        <Elevation>{elev}</Elevation>
        <Depth>0</Depth>
        <SampleRate>100</SampleRate>
        <Response>
          <InstrumentSensitivity>
            <Value>4.8e8</Value>
            <Frequency>5.0</Frequency>
            <InputUnits><Name>M/S</Name></InputUnits>
            <OutputUnits><Name>COUNTS</Name></OutputUnits>
          </InstrumentSensitivity>
          <Stage number="1">
            <PolesZeros>
              <InputUnits><Name>M/S</Name></InputUnits>
              <OutputUnits><Name>V</Name></OutputUnits>
              <PzTransferFunctionType>LAPLACE (RADIANS/SECOND)</PzTransferFunctionType>
              <NormalizationFactor>1.0</NormalizationFactor>
              <NormalizationFrequency>5.0</NormalizationFrequency>
              <Zero number="0"><Real>0</Real><Imaginary>0</Imaginary></Zero>
              <Zero number="1"><Real>0</Real><Imaginary>0</Imaginary></Zero>
              <Pole number="0"><Real>-0.1486</Real><Imaginary>0.1486</Imaginary></Pole>
              <Pole number="1"><Real>-0.1486</Real><Imaginary>-0.1486</Imaginary></Pole>
            </PolesZeros>
          </Stage>
        </Response>
      </Channel>"""


def _make_z7_stationxml(stations, path):
    blocks = []
    for _, stn in stations.iterrows():
        channels = "".join(
            _CHANNEL_BLOCK.format(
                comp=c, lat=stn.Latitude, lon=stn.Longitude,
                elev=-stn.Elevation * 1000,
            )
            for c in "ZNE"
        )
        blocks.append(
            f'    <Station code="{stn.Name}">\n'
            f"      <Latitude>{stn.Latitude}</Latitude>\n"
            f"      <Longitude>{stn.Longitude}</Longitude>\n"
            f"      <Elevation>{-stn.Elevation * 1000}</Elevation>\n"
            f"{channels}\n"
            "    </Station>"
        )
    path.write_text(_STATIONXML_HEAD.format(stations="\n".join(blocks)))


@pytest.fixture(scope="module")
def located_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("vt_parity")

    stations = read_stations(INPUTS / "iceland_stations.txt")
    vmodel = read_vmodel(INPUTS / "iceland_vmodel.txt")

    gproj = Proj(
        proj="lcc", units="km", lon_0=-16.9, lat_0=64.8, lat_1=64.7,
        lat_2=64.9, datum="WGS84", ellps="WGS84", no_defs=True,
    )
    cproj = Proj(proj="longlat", datum="WGS84", ellps="WGS84", no_defs=True)
    grid_spec = dict(
        ll_corner=[-17.2, 64.7, -2.0],
        ur_corner=[-16.6, 64.95, 16.0],
        node_spacing=[NODE_SPACING] * 3,
        grid_proj=gproj,
        coord_proj=cproj,
    )
    # Native eikonal sweep instead of the reference's NonLinLoc subprocess
    lut = compute_traveltimes(
        grid_spec, stations, method="1dsweep", phases=["P", "S"],
        vmod=vmodel, sweep_dx=0.1,
    )

    day_dir = root / "mSEED" / "2014" / "236"
    day_dir.mkdir(parents=True)
    for m_file in BENCH.glob("*.m"):
        shutil.copy(m_file, day_dir / m_file.name)

    response_file = root / "Z7_generated.xml"
    _make_z7_stationxml(stations, response_file)
    archive = Archive(
        archive_path=root / "mSEED", stations=stations,
        format="{year}/{jday:03d}/*",
        response_inv=read_response_inv(str(response_file)),
        response_removal_params={
            "pre_filt": (0.05, 0.06, 30, 35),
            "water_level": 60.0,
            "remove_full_response": False,
        },
    )

    onset = STALTAOnset(
        position="centred", sampling_rate=50, signal_transform="env_squared"
    )
    onset.phases = ["P", "S"]
    onset.bandpass_filters = {"P": [2, 16, 2], "S": [2, 16, 2]}
    onset.sta_lta_windows = {"P": [0.2, 1.0], "S": [0.2, 1.0]}

    # Amplitude/magnitude parameters from the reference's VT locate script
    # (examples/Volcanotectonic_Iceland/dike_intrusion_locate.py:60-77)
    mags = LocalMag(
        amp_params={
            "noise_window": 5.0,
            "noise_measure": "ENV",
            "signal_window": 1.0,
            "bandpass_filter": True,
            "bandpass_lowcut": 2.0,
            "bandpass_highcut": 20.0,
            "filter_corners": 4,
        },
        mag_params={
            "A0": "Greenfield2018_bardarbunga",
            "use_hyp_dist": True,
            "amp_feature": "S_amp",
            "trace_filter": ".*H[NE]$",
            "noise_filter": 3.0,
        },
        plot_amplitudes=False,
    )

    scan = QuakeScan(
        archive, lut, onset=onset, run_path=str(root / "runs"),
        run_name="vt_parity", marginal_window=1.0, precision="double",
        plot_event_summary=False, mags=mags,
    )
    scan.locate(
        trigger_file=str(BENCH / "example_run_2014_236_TriggeredEvents.csv")
    )

    return root / "runs" / "vt_parity" / "locate"


def test_vt_event_parity(located_run):
    golden_events = sorted(BENCH.glob("*.event"))
    assert golden_events

    deg_per_km_lat = 1 / 111.2
    deg_per_km_lon = 1 / (111.2 * np.cos(np.deg2rad(64.8)))
    # Velocity-model equivalence tolerance: 2 node spacings
    tol_x = 2 * NODE_SPACING * deg_per_km_lon
    tol_y = 2 * NODE_SPACING * deg_per_km_lat
    tol_z = 2 * NODE_SPACING

    located = 0
    for golden_file in golden_events:
        ours_file = located_run / "events" / golden_file.name
        if not ours_file.exists():
            continue
        located += 1
        golden = pd.read_csv(golden_file).iloc[0]
        ours = pd.read_csv(ours_file).iloc[0]

        dt = abs(UTCDateTime(ours["DT"]) - UTCDateTime(golden["DT"]))
        assert dt <= 0.5, f"{golden_file.name}: otime off by {dt}"

        assert abs(ours["X"] - golden["X"]) < tol_x, golden_file.name
        assert abs(ours["Y"] - golden["Y"]) < tol_y, golden_file.name
        assert abs(ours["Z"] - golden["Z"]) < tol_z, golden_file.name

    assert located == len(golden_events), (
        f"only {located}/{len(golden_events)} golden events located"
    )


def test_vt_picks_agree(located_run):
    total, matched = 0, 0
    for golden_file in sorted(BENCH.glob("*.picks")):
        ours_file = located_run / "picks" / golden_file.name
        if not ours_file.exists():
            continue
        golden = pd.read_csv(golden_file)
        ours = pd.read_csv(ours_file)
        merged = golden.merge(
            ours, on=["Station", "Phase"], suffixes=("_ref", "_ours")
        )
        for _, row in merged.iterrows():
            if str(row["PickTime_ref"]) == "-1":
                continue
            total += 1
            if str(row["PickTime_ours"]) == "-1":
                continue
            diff = abs(
                UTCDateTime(str(row["PickTime_ours"]))
                - UTCDateTime(str(row["PickTime_ref"]))
            )
            if diff <= 0.1:  # 5 samples at 50 Hz
                matched += 1

    assert total > 0
    # Every reference-made pick agrees within 0.1 s on the current tree
    # (tools/pick_audit.py, round 4: 457/457), including the file the
    # reference's own CI skips for an FP instability
    # (ref tests/test_benchmarks.py:154-156) -- hold the line at 100%.
    # Misses, if they reappear, must be classified and allowlisted with
    # a reason (see tools/pick_audit.py), not absorbed by a ratio.
    assert matched == total, f"only {matched}/{total} picks agree"


def test_vt_amplitude_structural_parity(located_run):
    """
    Amplitude-measurement chain vs the golden .amps, on real data. The true
    Z7 instrument gains are unknown (inventory not bundled), so amplitudes
    are compared up to one constant per station; measurement times and
    filter gains are compared absolutely.

    """

    rows = []
    for golden_file in sorted(BENCH.glob("*.amps")):
        ours_file = located_run / "amplitudes" / golden_file.name
        if not ours_file.exists():
            continue
        merged = (
            pd.read_csv(golden_file, index_col=0)
            .join(pd.read_csv(ours_file, index_col=0),
                  lsuffix="_ref", rsuffix="_ours")
            .dropna(subset=["S_amp_ref", "S_amp_ours"])
        )
        for trace_id, row in merged.iterrows():
            rows.append(
                {
                    "station": trace_id.split(".")[1],
                    "damp": np.log10(row["S_amp_ours"] / row["S_amp_ref"]),
                    "dgain": row["S_filter_gain_ours"] - row["S_filter_gain_ref"],
                    "dtime": abs(
                        UTCDateTime(str(row["S_time_ours"]))
                        - UTCDateTime(str(row["S_time_ref"]))
                    ),
                }
            )
    table = pd.DataFrame(rows)
    assert len(table) > 500, "too few joint amplitude observations"

    # Measurement windows land on the same swing: times match absolutely.
    assert (table["dtime"] <= 0.1).mean() > 0.70, table["dtime"].describe()

    # Filter-gain correction is instrument-independent: absolute agreement.
    assert (table["dgain"].abs() <= 0.05).mean() > 0.95

    # Per-station gain offsets are constants; their scatter measures the
    # fidelity of the peak-to-trough measurement itself.
    per_station = table.groupby("station")["damp"]
    assert (per_station.std() <= 0.06).all(), per_station.std()
    spread = per_station.mean() - table["damp"].mean()
    assert spread.abs().max() < 0.12, per_station.mean()


def test_vt_network_ml_parity(located_run):
    """
    Network-mean local magnitudes vs the golden .event files: equal up to
    the single unknown gain constant, with matching uncertainties and
    matching skip behaviour on the magnitude-less event.

    """

    offsets, err_diffs = [], []
    for golden_file in sorted(BENCH.glob("*.event")):
        ours_file = located_run / "events" / golden_file.name
        if not ours_file.exists():
            continue
        golden = pd.read_csv(golden_file).iloc[0]
        ours = pd.read_csv(ours_file).iloc[0]

        if not np.isfinite(golden["ML"]):
            # The reference also failed to measure this event's magnitude.
            assert not np.isfinite(ours["ML"]), golden_file.name
            continue
        assert np.isfinite(ours["ML"]), golden_file.name
        offsets.append(ours["ML"] - golden["ML"])
        err_diffs.append(abs(ours["ML_Err"] - golden["ML_Err"]))

    offsets = np.array(offsets)
    assert len(offsets) >= 20
    # One global gain constant: the offset must be the SAME for every event.
    assert offsets.std() < 0.05, offsets
    assert offsets.max() - offsets.min() < 0.15, offsets
    # Uncertainties are gain-free and should agree closely.
    assert np.median(err_diffs) < 0.05, err_diffs
