# -*- coding: utf-8 -*-
"""
quakemigrate_tpu -- earthquake detection and location by waveform
migration and stacking, on NVIDIA GPUs.

A ground-up re-implementation of the QuakeMigrate method
(QuakeMigrate/QuakeMigrate) for accelerators: the migration and stacking
compute core runs as fused JAX/XLA/Pallas device programs with the 3-D
search grid shardable across a device mesh, while waveform I/O,
triggering and magnitude estimation run host-side on a native seismic data
layer (no ObsPy/pyproj dependency).

"""

__version__ = "0.5.0"

from quakemigrate_tpu.io import Archive, read_lut, read_stations  # noqa: F401
from quakemigrate_tpu.lut import LUT, compute_traveltimes, read_nlloc  # noqa: F401
from quakemigrate_tpu.signal import QuakeScan, Trigger  # noqa: F401
