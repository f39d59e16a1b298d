# -*- coding: utf-8 -*-
"""
Reference-shaped compute bindings.

The reference exposes its C kernels as public Python functions
(``quakemigrate.core.migrate`` / ``find_max_coa`` / the three STA/LTA
variants, reference core/lib.py:52-285). This package's equivalents live
in :mod:`quakemigrate_tpu.ops` as JAX programs with device-native layouts
(flattened node axis, fused reductions); these wrappers re-express them
under the reference call signatures — numpy in, numpy out, 4-D map layout
— so scripts written against the reference's core API run unchanged.

``threads`` is accepted for API parity and ignored: parallelism here is
XLA's, not OpenMP's.
"""

import numpy as np

from quakemigrate_tpu import util


@util.timeit()
def migrate(onsets, traveltimes, first_idx, last_idx, available, threads=1):
    """
    Migrate onset functions along integer-sample traveltimes and stack
    into a 4-D coalescence map (reference core/lib.py:52-125 /
    migratelib.c:40-65).

    Parameters
    ----------
    onsets : array, shape (n_onsets, t_samples)
        Raw (un-logged) onset functions; clipped to >= 0.01 and logged
        internally, as in the reference binding.
    traveltimes : int array, shape (nx, ny, nz, n_onsets)
        Traveltimes as integer multiples of the sampling rate.
    first_idx, last_idx : int
        Pre-/post-pad sample counts trimmed from the scan range.
    available : int
        Number of available onset functions (the stack divisor).
    threads : int, optional
        Accepted for reference API parity; ignored.

    Returns
    -------
    map4d : float64 array, shape (nx, ny, nz, t_samples - first_idx - last_idx)

    """

    from quakemigrate_tpu.ops.migrate import migrate_map

    onsets = np.asarray(onsets)
    traveltimes = np.asarray(traveltimes)
    *grid_dims, n_luts = traveltimes.shape
    n_onsets, t_samples = onsets.shape
    n_samples = int(t_samples - first_idx - last_idx)

    if n_luts != n_onsets:
        raise ValueError(
            "Mismatch between number of stations for data and LUT, "
            f"{n_onsets}:{n_luts}"
        )
    if onsets.size < n_samples + first_idx:
        raise ValueError("Data array smaller than coalescence array.")

    tt_flat = np.ascontiguousarray(
        traveltimes.reshape(-1, n_onsets).astype(np.int32)
    )
    mask = np.ones(n_onsets, dtype=np.float32)
    map_flat = migrate_map(
        onsets.astype(np.float32), tt_flat, mask, float(available),
        int(first_idx), n_samples,
    )
    return np.asarray(map_flat, dtype=np.float64).reshape(
        tuple(grid_dims) + (n_samples,)
    )


@util.timeit()
def find_max_coa(map4d, threads=1):
    """
    Per-sample max / normalised max / argmax over the grid of a 4-D
    coalescence map (reference core/lib.py:131-170 / migratelib.c:85-111).

    Returns ``(max_coa f64[n], max_norm_coa f64[n], max_coa_idx i64[n])``
    with flat (C-order) node indices, like the reference.

    """

    from quakemigrate_tpu.ops import migrate as _m

    map4d = np.asarray(map4d)
    *grid_dims, n_samples = map4d.shape
    n_nodes = int(np.prod(grid_dims))
    max_coa, max_norm_coa, max_idx = _m.find_max_coa(
        map4d.reshape(n_nodes, n_samples).astype(np.float32)
    )
    return (
        np.asarray(max_coa, dtype=np.float64),
        np.asarray(max_norm_coa, dtype=np.float64),
        np.asarray(max_idx, dtype=np.int64),
    )


def _stalta(kind, signal, nsta, nlta):
    from quakemigrate_tpu.ops import stalta as _s

    signal = np.ascontiguousarray(signal, dtype=np.float32)
    fn = getattr(_s, kind)
    return np.asarray(fn(signal, int(nsta), int(nlta)), dtype=np.float64)


def overlapping_sta_lta(signal, nsta, nlta):
    """Classic STA/LTA, STA at the trailing end of the LTA window
    (reference core/lib.py:176-208 / onsetlib.c:35-59)."""

    return _stalta("overlapping_sta_lta", signal, nsta, nlta)


def centred_sta_lta(signal, nsta, nlta):
    """Centred STA/LTA, STA window after the LTA window (reference
    core/lib.py:214-246 / onsetlib.c:79-108)."""

    return _stalta("centred_sta_lta", signal, nsta, nlta)


def recursive_sta_lta(signal, nsta, nlta):
    """Recursive (exponential-decay) STA/LTA (reference
    core/lib.py:252-285 / onsetlib.c:126-148)."""

    return _stalta("recursive_sta_lta", signal, nsta, nlta)
