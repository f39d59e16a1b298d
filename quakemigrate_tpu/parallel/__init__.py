# -*- coding: utf-8 -*-
"""
quakemigrate_tpu.parallel -- multi-device execution of the scan engine.

The 3-D search grid's node axis is the natural parallel axis (the reference
parallelises the same axis with OpenMP threads on one host,
migratelib.c:49-51). Here it shards across a JAX device mesh: each device
owns a slab of grid nodes (a slab of the traveltime table) plus a replicated
copy of the (small) onset block, computes its local fused migrate+reduce,
and the per-sample max/argmax/sum combine is three collectives (NCCL
between GPUs):

- sum    -> psum
- max    -> pmax
- argmax -> pmax followed by a pmin over candidate indices, which
            reproduces the reference's first-index tie-breaking exactly.

A second mesh axis ("batch") parallelises over independent scan windows
(timesteps in detect, events in locate) -- pure data parallelism with no
collectives. Onsets for different windows shard over "batch" while the
traveltime table shards over "grid" (it is replicated across "batch").

"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from quakemigrate_tpu.ops.migrate import DEFAULT_TILE, detect_reduce


def make_mesh(devices=None, axis_names=("grid",), shape=None):
    """
    Build a device mesh. By default a 1-D mesh over all devices named
    "grid"; pass shape + axis_names for 2-D ("batch", "grid") layouts.

    """

    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices)
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis meshes")
        shape = (len(devices),)
    return Mesh(devices.reshape(shape), axis_names)


def pad_nodes_for_mesh(traveltimes, n_shards, tile=DEFAULT_TILE):
    """
    Pad the node axis of an [N, O] traveltime table (trailing rows) so it
    divides evenly into ``n_shards`` shards of whole tiles.
    Returns (padded_table, n_real_nodes).

    """

    n = traveltimes.shape[0]
    per_shard = -(-n // (n_shards * tile)) * tile
    pad = per_shard * n_shards - n
    if pad:
        traveltimes = np.pad(traveltimes, ((0, pad), (0, 0)))
    return traveltimes, n


def make_sharded_detect(
    mesh, fsmp, nsamples, n_nodes_real, tile=DEFAULT_TILE, grid_axis="grid",
    batch_axis=None,
):
    """
    Build a jitted, mesh-sharded fused migrate+reduce.

    The returned function has signature
    ``f(onsets, traveltimes, mask, available) -> (max_coa, max_norm, idx)``
    where ``traveltimes`` [N_padded, O] is sharded over ``grid_axis``
    (N_padded must divide evenly; see :func:`pad_nodes_for_mesh`).

    If ``batch_axis`` is given, ``onsets`` gains a leading batch dimension
    [B, O, T] sharded over that axis (with mask/available [B, O] / [B]),
    and the outputs gain a matching leading dimension -- data parallelism
    over scan windows on top of grid parallelism.

    """

    n_shards = mesh.shape[grid_axis]

    def _local(onsets, tt_local, mask, available):
        shard = jax.lax.axis_index(grid_axis)
        offset = shard * tt_local.shape[0]
        mx, idx, sm = detect_reduce(
            onsets, tt_local, mask, available, fsmp, nsamples,
            n_nodes_real, tile=tile, node_offset=offset,
        )
        return _combine_shards(mx, idx, sm, n_nodes_real, grid_axis)

    if batch_axis is None:
        in_specs = (P(), P(grid_axis, None), P(), P())
        out_specs = (P(), P(), P())
        fn = _local
    else:
        in_specs = (
            P(batch_axis, None, None),
            P(grid_axis, None),
            P(batch_axis, None),
            P(batch_axis),
        )
        out_specs = (P(batch_axis, None), P(batch_axis, None), P(batch_axis, None))

        def fn(onsets_b, tt_local, mask_b, available_b):
            return jax.vmap(
                lambda o, m, a: _local(o, tt_local, m, a)
            )(onsets_b, mask_b, available_b)

    sharded = shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False
    )
    return jax.jit(sharded)


def make_sharded_marginalise(
    mesh, fsmp, nsamples, tile=DEFAULT_TILE, grid_axis="grid",
):
    """
    Build a jitted, mesh-sharded window marginalisation -- the second
    pass of the two-pass locate (pass 1 = the fused reduce that finds
    the origin time). Each device marginalises its own slab of grid
    nodes over the dynamic [window_start, window_start + window_length)
    sample window; the outputs concatenate along the node axis with no
    collective (the marginalised map is per-node).

    The returned function has signature
    ``f(onsets, traveltimes, mask, available, window_start,
    window_length) -> coa_3d_flat [N_padded]`` where ``traveltimes``
    [N_padded, O] is sharded over ``grid_axis`` (N_padded must divide
    evenly; see :func:`pad_nodes_for_mesh`) -- the caller drops the
    padded tail rows.

    """

    from quakemigrate_tpu.ops.migrate import migrate_marginalise

    def _local(onsets, tt_local, mask, available, wstart, wlength):
        return migrate_marginalise(
            onsets, tt_local, mask, available, fsmp, nsamples,
            wstart, wlength, tile=tile,
        )

    in_specs = (P(), P(grid_axis, None), P(), P(), P(), P())
    sharded = shard_map(
        _local, mesh=mesh, in_specs=in_specs, out_specs=P(grid_axis),
        check_vma=False,
    )
    return jax.jit(sharded)


def _batch_specs(in_specs, out_specs, batch_axis, n_batched):
    """
    Prepend a batch dimension (sharded over ``batch_axis``) to the first
    ``n_batched`` input specs and to every output spec.

    """

    batched_in = tuple(
        P(batch_axis, *spec) if i < n_batched else spec
        for i, spec in enumerate(in_specs)
    )
    batched_out = tuple(P(batch_axis, *spec) for spec in out_specs)
    return batched_in, batched_out


def make_sharded_detect_fused(
    mesh, position, transform, min_onset_value, fsmp, nsamples,
    n_nodes_real, tile=DEFAULT_TILE, grid_axis="grid", batch_axis=None,
):
    """
    Mesh-sharded version of :func:`ops.scan_window.detect_window_fused`:
    the WHOLE detect window (signal transform -> dynamic-window STA/LTA ->
    RMS combine -> clip -> migrate -> reduce) as one jitted program over
    the device mesh.

    The onset front-end is tiny (O(slots x T)) so every device computes it
    redundantly from the replicated channel block; only the migration
    (O(nodes x onsets x samples)) shards, over ``grid_axis``. Returned
    signature:
    ``f(channels, chan_mask, slot_mask, nsta, nlta, traveltimes_padded)
    -> (max_coa, max_norm_coa, max_idx)``
    with ``traveltimes_padded`` from :func:`pad_nodes_for_mesh`.

    With ``batch_axis``, channels/chan_mask/slot_mask gain a leading
    window-batch dimension sharded over that axis (nsta/nlta and the
    traveltimes are shared across windows), and the outputs gain a
    matching leading dimension: window data-parallelism on top of grid
    parallelism. Inert pad windows (all-ones channels, zero masks) keep
    the batch size fixed; their ``available`` is clamped to 1 so the
    normalisation never divides by zero.

    """

    from quakemigrate_tpu.ops.scan_window import fused_onsets

    def _one(channels, chan_mask, slot_mask, nsta, nlta, tt_local):
        combined, available = fused_onsets(
            channels, chan_mask, slot_mask, nsta, nlta,
            position, transform, min_onset_value,
        )
        if batch_axis is not None:
            available = jnp.maximum(available, 1.0)
        return _local_reduce_combine(
            combined, slot_mask, available, tt_local, fsmp, nsamples,
            n_nodes_real, tile, grid_axis,
        )

    in_specs = (P(), P(), P(), P(), P(), P(grid_axis, None))
    out_specs = (P(), P(), P())
    fn = _one
    if batch_axis is not None:
        in_specs, out_specs = _batch_specs(in_specs, out_specs, batch_axis, 3)
        # channels/chan_mask/slot_mask carry the window axis
        fn = jax.vmap(_one, in_axes=(0, 0, 0) + (None,) * (len(in_specs) - 3))

    sharded = shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(sharded)


def _local_reduce_combine(
    combined, slot_mask, available, tt_local, fsmp, nsamples, n_nodes_real,
    tile, grid_axis,
):
    """Per-shard fused reduce + collective combine (shared by the
    STA/LTA and kurtosis sharded windows)."""

    shard = jax.lax.axis_index(grid_axis)
    offset = shard * tt_local.shape[0]
    mx, idx, sm = detect_reduce(
        combined, tt_local, slot_mask, available, fsmp, nsamples,
        n_nodes_real, tile=tile, node_offset=offset,
    )
    return _combine_shards(mx, idx, sm, n_nodes_real, grid_axis)


def _combine_shards(mx, idx, sm, n_nodes_real, grid_axis):
    """
    The cross-shard reduction shared by every sharded detect variant:
    pmax for the max, psum for the normalisation sum, and the argmax
    tie-break -- candidates not attaining the global max are replaced by
    INT32_MAX so a pmin reproduces the reference's first-index rule.
    Returns (max_coa, max_norm_coa, max_idx).

    """

    gmax = jax.lax.pmax(mx, grid_axis)
    gsum = jax.lax.psum(sm, grid_axis)
    big = jnp.asarray(np.iinfo(np.int32).max, dtype=idx.dtype)
    cand = jnp.where(mx == gmax, idx, big)
    gidx = jax.lax.pmin(cand, grid_axis)
    return gmax, gmax * n_nodes_real / gsum, gidx


def make_sharded_detect_fused_kurtosis(
    mesh, nsmooth, taper_pad, min_onset_value, fsmp, nsamples,
    n_nodes_real, tile=DEFAULT_TILE, grid_axis="grid", batch_axis=None,
):
    """
    Mesh-sharded version of
    :func:`ops.scan_window.detect_window_fused_kurtosis`: the whole
    kurtosis detect window as one jitted program over the device mesh
    (onset front-end replicated per device, migration sharded).
    Signature:
    ``f(channels, chan_mask, slot_mask, nkurt, traveltimes_padded)``.
    ``batch_axis`` as in :func:`make_sharded_detect_fused`.

    """

    from quakemigrate_tpu.ops.scan_window import fused_kurtosis_onsets

    def _one(channels, chan_mask, slot_mask, nkurt, tt_local):
        combined, available = fused_kurtosis_onsets(
            channels, chan_mask, slot_mask, nkurt, nsmooth, taper_pad,
            min_onset_value,
        )
        if batch_axis is not None:
            available = jnp.maximum(available, 1.0)
        return _local_reduce_combine(
            combined, slot_mask, available, tt_local, fsmp, nsamples,
            n_nodes_real, tile, grid_axis,
        )

    in_specs = (P(), P(), P(), P(), P(grid_axis, None))
    out_specs = (P(), P(), P())
    fn = _one
    if batch_axis is not None:
        in_specs, out_specs = _batch_specs(in_specs, out_specs, batch_axis, 3)
        # channels/chan_mask/slot_mask carry the window axis
        fn = jax.vmap(_one, in_axes=(0, 0, 0) + (None,) * (len(in_specs) - 3))

    sharded = shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )
    return jax.jit(sharded)
