# -*- coding: utf-8 -*-
"""
Template: run the detect stage (continuous coalescence scan).

"""

from quakemigrate_tpu import QuakeScan
from quakemigrate_tpu.io import Archive, read_lut, read_stations
from quakemigrate_tpu.signal.onsets import STALTAOnset

station_file = "./inputs/stations.txt"
data_in = "./inputs/mSEED"
lut_file = "./outputs/lut/example.LUT"
run_path = "./outputs/runs"
run_name = "example_run"

starttime = "2014-06-29T18:41:55.0"
endtime = "2014-06-29T18:42:20.0"

stations = read_stations(station_file)

archive = Archive(
    archive_path=data_in, stations=stations, archive_format="YEAR/JD/STATION"
)

lut = read_lut(lut_file=lut_file)
# Optionally decimate the grid for the continuous scan (locate re-runs on
# the full-resolution grid):
# lut = lut.decimate([2, 2, 2])

onset = STALTAOnset(position="classic", sampling_rate=250)
onset.phases = ["P", "S"]
onset.bandpass_filters = {"P": [10, 124, 4], "S": [10, 124, 4]}
onset.sta_lta_windows = {"P": [0.01, 0.25], "S": [0.05, 0.5]}

scan = QuakeScan(
    archive,
    lut,
    onset=onset,
    run_path=run_path,
    run_name=run_name,
    log=True,
    loglevel="info",
)

scan.timestep = 2.5
# Device execution options:
# scan.precision = "single"   # float32 device compute (default)
# scan.mesh = quakemigrate_tpu.parallel.make_mesh()  # shard grid over GPUs

scan.detect(starttime, endtime)
