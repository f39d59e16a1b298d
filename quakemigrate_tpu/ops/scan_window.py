# -*- coding: utf-8 -*-
"""
Fully-fused detect window: signal transform -> STA/LTA -> multi-component
RMS combine -> onset clip -> log-domain migration -> per-sample grid
reduction, as ONE jitted device program.

This realises the design target that "everything inside _compute is one
jitted device program" (SURVEY.md §3.1): per scan window the host only
prepares a fixed-shape channel block; a single device call returns the
coalescence trace extrema. Station availability, channel counts and
per-phase STA/LTA window lengths are all data (masks / per-slot sample
counts), so nothing recompiles as the network changes.

Inputs are organised by canonical (phase, station) slot:

    channels  [n_slots, C_max, T]  pre-processed waveforms (zeros when
                                   absent)
    chan_mask [n_slots, C_max]     1.0 for live channels
    slot_mask [n_slots]            1.0 for slots with >= 1 live channel
    nsta/nlta [n_slots]            STA/LTA window lengths in samples

"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .migrate import detect_reduce
from .rolling import padded_cumsum, trailing_window_sums
from .stalta import _envelope


def _windowed_sums_dynamic(x, n):
    """
    Trailing-window rolling sums with a per-row window length:
    out[r, i] = sum(x[r, max(0, i+1-n[r]) : i+1]).

    """

    return trailing_window_sums(x, n)


def _sta_lta_dynamic(signal, nsta, nlta, position):
    """
    Batched STA/LTA with per-row window lengths (rows may belong to
    different phases). ``position`` is static ("classic" or "centred").
    Semantics match ops.stalta (and the reference C kernels).

    """

    if position not in ("classic", "centred"):
        raise ValueError(f"Unknown STA/LTA position: {position}")

    t = signal.shape[-1]
    idx = jnp.arange(t)
    tiny = jnp.finfo(signal.dtype).tiny
    nsta_col = nsta[:, None]
    nlta_col = nlta[:, None]
    # NOTE: int32/int32 true-divide promotes to float32 regardless of x64;
    # cast to the signal dtype to keep full precision
    frac = nlta_col.astype(signal.dtype) / nsta_col.astype(signal.dtype)

    if position == "classic":
        sta = _windowed_sums_dynamic(signal, nsta)
        lta = _windowed_sums_dynamic(signal, nlta)
        ratio = jnp.where(lta < tiny, 1.0, sta / jnp.maximum(lta, tiny) * frac)
        valid = idx[None, :] >= (nlta_col - 1)
        return jnp.where(valid, ratio, 1.0)

    # centred: lta trails, sta leads
    padded = padded_cumsum(signal)
    hi = padded[..., idx + 1]
    lo_idx = jnp.maximum(idx[None, :] + 1 - nlta_col, 0)
    lta = hi - jnp.take_along_axis(padded, lo_idx, axis=-1)
    sta_hi_idx = jnp.minimum(idx[None, :] + 1 + nsta_col, t)
    sta = jnp.take_along_axis(padded, sta_hi_idx, axis=-1) - hi
    ratio = jnp.where(lta <= 0.0, 1.0, sta / jnp.maximum(lta, tiny) * frac)
    valid = (idx[None, :] >= (nlta_col - 1)) & (
        idx[None, :] < t - nsta_col
    )
    return jnp.where(valid, ratio, 1.0)


@jax.jit
def pack_detect_window(max_coa, max_norm_coa, max_idx):
    """
    Pack a detect window's three per-sample outputs into ONE [3, S] array
    so the host pays one device-to-host transfer per window instead of
    three.

    The packed array is INTEGER-typed: the coalescence floats are bitcast
    into same-width int bits. The inverse -- bitcasting the indices into
    float bits -- is unsafe: every node index below 2^23 is a float32
    *subnormal* bit pattern, which a backend may flush to zero in any
    vector op that moves the packed array. Integer lanes are never
    flushed or NaN-canonicalised, so float-bits-in-int is the safe
    direction.

    """

    if max_coa.dtype == jnp.float64:
        int_dtype = jnp.int64
    else:
        int_dtype = jnp.int32
    coa_bits = jax.lax.bitcast_convert_type(max_coa, int_dtype)
    norm_bits = jax.lax.bitcast_convert_type(max_norm_coa, int_dtype)
    return jnp.stack([coa_bits, norm_bits, max_idx.astype(int_dtype)])


def unpack_detect_window(packed):
    """Host-side inverse of :func:`pack_detect_window` (numpy in)."""

    packed = np.asarray(packed)
    float_dtype = np.float64 if packed.dtype == np.int64 else np.float32
    max_coa = np.ascontiguousarray(packed[0]).view(float_dtype)
    max_norm = np.ascontiguousarray(packed[1]).view(float_dtype)
    return max_coa, max_norm, packed[2].astype(np.int32, copy=False)


def fused_onsets(
    channels, chan_mask, slot_mask, nsta, nlta,
    position, transform, min_onset_value,
):
    """
    Device-side onset front-end of the fused window: signal transform ->
    per-slot dynamic-window STA/LTA -> RMS channel combine -> clip.
    Returns (combined [n_slots, T], available) ready for migration.
    Traceable (no jit wrapper) so it composes under shard_map.

    """

    n_slots, c_max, t = channels.shape
    rows = channels.reshape(n_slots * c_max, t)

    # --- Signal transform ---
    if transform == "energy":
        rows = rows**2
    elif transform == "abs":
        rows = jnp.abs(rows)
    elif transform in ("env", "env_squared"):
        env = _envelope(rows)
        rows = env**2 if transform == "env_squared" else env
    else:
        raise ValueError(f"Unknown signal transform: {transform}")

    # --- STA/LTA with per-slot window lengths ---
    nsta_rows = jnp.repeat(nsta, c_max)
    nlta_rows = jnp.repeat(nlta, c_max)
    onsets_rows = _sta_lta_dynamic(rows, nsta_rows, nlta_rows, position)

    # --- RMS combine live channels per slot + clip ---
    onsets_c = onsets_rows.reshape(n_slots, c_max, t)
    weights = chan_mask[..., None]
    n_live = jnp.maximum(chan_mask.sum(axis=1), 1.0)[:, None]
    combined = jnp.sqrt((onsets_c**2 * weights).sum(axis=1) / n_live)
    combined = jnp.clip(combined, min_onset_value, None)
    # Dead slots -> onset of ones (log-domain zero; excluded via slot_mask)
    combined = jnp.where(slot_mask[:, None] == 1.0, combined, 1.0)

    return combined, slot_mask.sum()


def fused_kurtosis_onsets(
    channels, chan_mask, slot_mask, nkurt, nsmooth, taper_pad,
    min_onset_value,
):
    """
    Device-side onset front-end for the fused kurtosis window: per-row
    kurtosis characteristic function (per-slot window lengths) ->
    taper-edge neutralisation -> RMS channel combine -> clip. Returns
    (combined [n_slots, T], available). Traceable, so it composes under
    shard_map.

    """

    from .kurtosis import kurtosis_cf_rows

    n_slots, c_max, t = channels.shape
    rows = channels.reshape(n_slots * c_max, t)
    nkurt_rows = jnp.repeat(nkurt, c_max)

    cf = kurtosis_cf_rows(rows, nkurt_rows, nsmooth)

    # Neutralise the tapered edges (KurtosisOnset._combine sets the
    # first taper_pad + nkurt - 1 and last taper_pad samples to the
    # baseline 1.0)
    idx = jnp.arange(t)
    lo = (taper_pad + nkurt_rows - 1)[:, None]
    edge = (idx[None, :] < lo) | (idx[None, :] >= t - max(taper_pad, 1))
    cf = jnp.where(edge, 1.0, cf)

    onsets_c = cf.reshape(n_slots, c_max, t)
    weights = chan_mask[..., None]
    n_live = jnp.maximum(chan_mask.sum(axis=1), 1.0)[:, None]
    combined = jnp.sqrt((onsets_c**2 * weights).sum(axis=1) / n_live)
    combined = jnp.clip(combined, min_onset_value, None)
    combined = jnp.where(slot_mask[:, None] == 1.0, combined, 1.0)

    return combined, slot_mask.sum()


@partial(
    jax.jit,
    static_argnames=(
        "nsmooth", "taper_pad", "min_onset_value", "fsmp", "nsamples",
        "n_nodes_real", "tile",
    ),
)
def detect_window_fused_kurtosis(
    channels, chan_mask, slot_mask, nkurt, traveltimes,
    nsmooth, taper_pad, min_onset_value, fsmp, nsamples,
    n_nodes_real=None, tile=4096,
):
    """
    Fully-fused detect window for the kurtosis onset, as one device call.
    Matches KurtosisOnset._combine + migrate_detect.

    """

    combined, available = fused_kurtosis_onsets(
        channels, chan_mask, slot_mask, nkurt, nsmooth, taper_pad,
        min_onset_value,
    )
    n_real = traveltimes.shape[0] if n_nodes_real is None else n_nodes_real
    max_coa, max_idx, coa_sum = detect_reduce(
        combined, traveltimes, slot_mask, available, fsmp, nsamples,
        n_real, tile,
    )
    return max_coa, max_coa * n_real / coa_sum, max_idx


@partial(
    jax.jit,
    static_argnames=(
        "position", "transform", "min_onset_value", "fsmp", "nsamples",
        "n_nodes_real", "tile",
    ),
)
def detect_window_fused(
    channels, chan_mask, slot_mask, nsta, nlta, traveltimes,
    position, transform, min_onset_value, fsmp, nsamples,
    n_nodes_real=None, tile=4096,
):
    """
    One fused device call for a detect window. Returns
    (max_coa, max_norm_coa, max_idx) exactly as ops.migrate.migrate_detect
    would when fed the equivalent host-computed onsets.

    """

    combined, available = fused_onsets(
        channels, chan_mask, slot_mask, nsta, nlta,
        position, transform, min_onset_value,
    )
    n_real = traveltimes.shape[0] if n_nodes_real is None else n_nodes_real
    max_coa, max_idx, coa_sum = detect_reduce(
        combined, traveltimes, slot_mask, available, fsmp, nsamples,
        n_real, tile,
    )
    return max_coa, max_coa * n_real / coa_sum, max_idx
