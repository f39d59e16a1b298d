# -*- coding: utf-8 -*-
"""
Migration / coalescence-stacking device programs -- the heart of the scan
engine.

These replace the reference's C/OpenMP kernels ``migrate`` and
``find_max_coa`` (migratelib.c:40-111), redesigned rather than
translated:

- The onset functions are clipped and moved to the log domain on-device, so
  the geometric-mean stack is a masked arithmetic mean of logs followed by a
  single exp (reference does the log host-side, core/lib.py:89-94).
- Inputs are fixed-shape and mask-padded: the onset block is [O_max, T]
  with a float mask [O_max], so station availability changes do NOT trigger
  recompilation (the reference rebuilds the traveltime stack per timestep).
- detect mode fuses the per-sample max/argmax/sum grid reduction into the
  stack, so the 4-D coalescence map NEVER materialises in device memory
  (the reference allocates then immediately frees it, scan.py:635-642).
  On a GPU this is one Pallas kernel (ops.gather_migrate) that gathers
  straight from the onset rows; elsewhere, and in float64, it is the XLA
  shift-table program below.
- locate mode retains the (flattened) map4d for marginalisation.

Tie-breaking matches the C kernel: the FIRST node index achieving the
maximum wins (migratelib.c:101-105).

The node axis shards cleanly across a device mesh; see
quakemigrate_tpu.parallel for the collective combine.

"""

from functools import partial

import jax
import jax.numpy as jnp

from .gather_migrate import gather_detect_reduce

# Node-tile size of the XLA shift-table programs (locate's map and
# marginalisation, float64 detect, CPU hosts). Swept over 1024-8192 on an
# H100 (PERF.md): 8192 shaves ~3% off a detect window, but locate per
# event was fastest at 2048-4096 and slowest at 8192, so 4096 stays.
DEFAULT_TILE = 4096

MIN_ONSET_CLIP = 0.01  # matches reference core/lib.py:93


def _prepare_onsets(onsets, mask):
    """Clip, log, and zero-out masked onset rows."""

    logged = jnp.log(jnp.clip(onsets, MIN_ONSET_CLIP, None))
    return logged * mask[:, None]


def _build_shift_table(onsets_log, fsmp, nsamples):
    """
    Materialise every possible shifted scan window of each onset row:
    H[o, d, s] = onsets_log[o, fsmp + d + s] for d in [0, T - fsmp - S].

    This turns the migration's per-node dynamic-offset reads into whole-row
    gathers from H, which XLA vectorises on every backend. H is
    ~O x lsmp x S floats (tens of MB for a short window), built once per
    device call with a scan of contiguous slices.

    """

    t_len = onsets_log.shape[-1]
    d_max = t_len - fsmp - nsamples  # == lsmp

    def body(_, d):
        return None, jax.lax.dynamic_slice_in_dim(
            onsets_log, fsmp + d, nsamples, axis=1
        )

    _, shifted = jax.lax.scan(
        body, None, jnp.arange(d_max + 1, dtype=jnp.int32)
    )
    # [D, O, S] -> [O, D, S]
    return jnp.transpose(shifted, (1, 0, 2)), d_max


_ONSET_GROUP = 4  # onsets accumulated per scan step (cuts accumulator
                  # round-trips through device memory by the same factor)


def _stack_tile(shift_table, d_max, tt_tile, mask, available):
    """
    Coalescence stack for one node tile.

    shift_table : [O, D, S] pre-shifted log-domain onset windows.
    tt_tile     : [Nt, O] int32 traveltime sample offsets.
    Returns [Nt, nsamples] coalescence values (geometric-mean stack).

    The scan runs over onset *groups*: each step gathers and adds
    _ONSET_GROUP rows so the [Nt, S] accumulator makes 1/group as many
    round-trips through device memory.

    """

    n_onsets = shift_table.shape[0]
    g = _ONSET_GROUP
    o_pad = -(-n_onsets // g) * g - n_onsets
    if o_pad:
        shift_table = jnp.pad(shift_table, ((0, o_pad), (0, 0), (0, 0)))
        tt_tile = jnp.pad(tt_tile, ((0, 0), (0, o_pad)))
        mask = jnp.pad(mask, (0, o_pad))
    n_groups = shift_table.shape[0] // g

    def body(acc, inputs):
        windows, tt_g, m = inputs  # [g, D, S], [g, Nt], [g]
        for j in range(g):
            rows = jnp.take(windows[j], jnp.clip(tt_g[j], 0, d_max), axis=0)
            acc = acc + m[j] * rows
        return acc, None

    acc0 = jnp.zeros(
        (tt_tile.shape[0], shift_table.shape[-1]), dtype=shift_table.dtype
    )
    acc, _ = jax.lax.scan(
        body,
        acc0,
        (
            shift_table.reshape(n_groups, g, *shift_table.shape[1:]),
            tt_tile.T.reshape(n_groups, g, -1),
            mask.reshape(n_groups, g),
        ),
    )
    return jnp.exp(acc / available)


def detect_reduce(
    onsets, traveltimes, mask, available, fsmp, nsamples, n_nodes_real,
    tile=DEFAULT_TILE, node_offset=0,
):
    """
    Core fused migrate + grid reduction over a (possibly padded) node slab.

    ``node_offset`` (traced or static) is the global flat index of this
    slab's first node; nodes whose global index is >= ``n_nodes_real`` are
    padding and excluded from both the max and the sum.

    Returns (max_coa [S], max_idx [S] global indices, coa_sum [S]).

    Float32 inputs run the Pallas gather kernel when compiled for a GPU and
    the XLA shift-table program otherwise; float64 always runs XLA.

    """

    onsets_log = _prepare_onsets(onsets, mask)
    available = jnp.asarray(available, onsets_log.dtype)
    node_offset = jnp.asarray(node_offset, jnp.int32)
    xla = partial(
        _detect_reduce_xla, fsmp=fsmp, nsamples=nsamples,
        n_nodes_real=n_nodes_real, tile=tile,
    )
    if onsets_log.dtype != jnp.float32:
        return xla(onsets_log, traveltimes, mask, available, node_offset)

    def gather(onsets_log, traveltimes, mask, available, node_offset):
        return gather_detect_reduce(
            onsets_log, traveltimes, available, fsmp, nsamples,
            n_nodes_real, node_offset=node_offset,
        )

    # The compile target picks the program: only the branch for the
    # platform being compiled for is lowered.
    return jax.lax.platform_dependent(
        onsets_log, traveltimes, mask, available, node_offset,
        cuda=gather, default=xla,
    )


def _detect_reduce_xla(onsets_log, traveltimes, mask, available, node_offset,
                       fsmp, nsamples, n_nodes_real, tile):
    """detect_reduce as the XLA shift-table program (log-domain onsets)."""

    n_total = traveltimes.shape[0]
    dtype = onsets_log.dtype
    shift_table, d_max = _build_shift_table(onsets_log, fsmp, nsamples)

    n_tiles = -(-n_total // tile)
    pad = n_tiles * tile - n_total
    tt_tiles = jnp.pad(traveltimes, ((0, pad), (0, 0))).reshape(n_tiles, tile, -1)

    node_idx_base = jnp.arange(tile, dtype=jnp.int32)

    def tile_body(carry, inputs):
        running_max, running_idx, running_sum = carry
        tt_tile, tile_i = inputs
        coa = _stack_tile(shift_table, d_max, tt_tile, mask, available)
        local_idx = tile_i * tile + node_idx_base
        global_idx = node_offset + local_idx
        # Both checks are needed: the tile padding appended to THIS slab
        # (local_idx >= n_total) is invalid even when its global index
        # happens to fall below n_nodes_real (a mid-grid slab whose
        # length is not a multiple of `tile`)
        valid = ((local_idx < n_total) & (global_idx < n_nodes_real))[:, None]
        coa = jnp.where(valid, coa, 0.0)
        tile_max = jnp.max(coa, axis=0)
        tile_arg = jnp.take(
            global_idx, jnp.argmax(coa, axis=0).astype(jnp.int32)
        )
        tile_sum = jnp.sum(coa, axis=0)
        better = tile_max > running_max  # strict: earlier tile wins ties
        return (
            jnp.where(better, tile_max, running_max),
            jnp.where(better, tile_arg, running_idx),
            running_sum + tile_sum,
        ), None

    init = (
        jnp.full(nsamples, -jnp.inf, dtype=dtype),
        jnp.zeros(nsamples, dtype=jnp.int32),
        jnp.zeros(nsamples, dtype=dtype),
    )
    (max_coa, max_idx, coa_sum), _ = jax.lax.scan(
        tile_body, init, (tt_tiles, jnp.arange(n_tiles, dtype=jnp.int32))
    )
    return max_coa, max_idx, coa_sum


@partial(
    jax.jit,
    static_argnames=("fsmp", "nsamples", "tile", "n_nodes_real"),
)
def migrate_detect(
    onsets, traveltimes, mask, available, fsmp, nsamples,
    n_nodes_real=None, tile=DEFAULT_TILE,
):
    """
    Fused migrate + find_max_coa for the detect stage (single device).

    Parameters
    ----------
    onsets : [O, T] float array
        Raw (positive) onset functions; clip/log happens on device.
    traveltimes : [N, O] int32
        Traveltime sample offsets, node-major. N may include trailing
        padding rows (excluded via ``n_nodes_real``).
    mask : [O] float
        1.0 for live onset rows, 0.0 for padding.
    available : scalar
        Number of live onsets (the geometric-mean divisor).
    fsmp : int (static)
        Index of the first scan sample (pre-pad length in samples).
    nsamples : int (static)
        Number of scan samples S; requires T >= fsmp + S.
    n_nodes_real : int (static), optional
        Number of real (non-padding) nodes. Defaults to N.

    Returns
    -------
    max_coa : [S] maximum coalescence per sample.
    max_norm_coa : [S] max * n_nodes / sum(coalescence).
    max_idx : [S] int32 flat node index of the maximum (first index wins).

    """

    n_real = traveltimes.shape[0] if n_nodes_real is None else n_nodes_real
    max_coa, max_idx, coa_sum = detect_reduce(
        onsets, traveltimes, mask, available, fsmp, nsamples, n_real, tile
    )
    return max_coa, max_coa * n_real / coa_sum, max_idx


@partial(
    jax.jit,
    static_argnames=("fsmp", "nsamples", "tile", "n_nodes_real"),
)
def migrate_detect_batch(
    onsets, traveltimes, mask, available, fsmp, nsamples,
    n_nodes_real=None, tile=DEFAULT_TILE,
):
    """
    Fused migrate + find_max_coa over a batch of independent scan windows:
    ``onsets`` [B, O, T], ``mask`` [B, O], ``available`` [B]; the
    traveltime table is shared. Returns per-window [B, S] outputs.

    Sharding windows over a mesh "batch" axis (quakemigrate_tpu.parallel)
    is the other way to parallelise windows.

    """

    n_real = traveltimes.shape[0] if n_nodes_real is None else n_nodes_real

    def single(o, m, a):
        return detect_reduce(
            o, traveltimes, m, a, fsmp, nsamples, n_real, tile
        )

    max_coa, max_idx, coa_sum = jax.vmap(single)(onsets, mask, available)
    return max_coa, max_coa * n_real / coa_sum, max_idx


@partial(jax.jit, static_argnames=("fsmp", "nsamples", "tile"))
def migrate_map(
    onsets, traveltimes, mask, available, fsmp, nsamples, tile=DEFAULT_TILE
):
    """
    Migration retaining the full coalescence map (locate stage).

    Returns map4d_flat [N, S] -- the flattened-node equivalent of the
    reference's map4d (nx, ny, nz, S).

    """

    onsets_log = _prepare_onsets(onsets, mask)
    shift_table, d_max = _build_shift_table(onsets_log, fsmp, nsamples)
    n_total = traveltimes.shape[0]
    n_tiles = -(-n_total // tile)
    pad = n_tiles * tile - n_total
    tt_tiles = jnp.pad(traveltimes, ((0, pad), (0, 0))).reshape(n_tiles, tile, -1)

    def tile_body(_, tt_tile):
        coa = _stack_tile(shift_table, d_max, tt_tile, mask, available)
        return None, coa

    _, tiles = jax.lax.scan(tile_body, None, tt_tiles)
    return tiles.reshape(n_tiles * tile, nsamples)[:n_total]


@partial(jax.jit, static_argnames=("fsmp", "nsamples", "tile"))
def migrate_marginalise(
    onsets, traveltimes, mask, available, fsmp, nsamples, window_start,
    window_length, tile=DEFAULT_TILE,
):
    """
    Migration marginalised over a time window, without materialising the
    4-D map: returns coa_3d_flat [N] = sum over samples in
    [window_start, window_start + window_length) of the coalescence.

    ``window_length`` is a boolean-mask length over the full ``nsamples``
    scan range (the window bounds are dynamic), so large-grid locate can
    marginalise on device in O(N) memory -- the second pass of the
    two-pass locate (pass 1 = the fused reduce that finds the origin
    time).

    """

    onsets_log = _prepare_onsets(onsets, mask)
    shift_table, d_max = _build_shift_table(onsets_log, fsmp, nsamples)
    n_total = traveltimes.shape[0]
    n_tiles = -(-n_total // tile)
    pad = n_tiles * tile - n_total
    tt_tiles = jnp.pad(traveltimes, ((0, pad), (0, 0))).reshape(n_tiles, tile, -1)

    sample_idx = jnp.arange(nsamples)
    in_window = (
        (sample_idx >= window_start)
        & (sample_idx < window_start + window_length)
    ).astype(onsets_log.dtype)

    def tile_body(_, tt_tile):
        coa = _stack_tile(shift_table, d_max, tt_tile, mask, available)
        # A masked sum, not a matrix product: a float32 product may run
        # in reduced precision (TF32) on GPUs.
        return None, jnp.sum(coa * in_window, axis=1)

    _, sums = jax.lax.scan(tile_body, None, tt_tiles)
    return sums.reshape(n_tiles * tile)[:n_total]


@partial(jax.jit, static_argnames=("n_nodes_real",))
def find_max_coa(map4d_flat, n_nodes_real=None, node_offset=0):
    """
    Per-sample max / normalised max / argmax over the node axis of a
    flattened coalescence map (the standalone equivalent of
    migratelib.c:85-111, for when the map has been materialised).

    """

    n_real = map4d_flat.shape[0] if n_nodes_real is None else n_nodes_real
    data = map4d_flat[:n_real]
    max_coa = jnp.max(data, axis=0)
    max_idx = jnp.argmax(data, axis=0).astype(jnp.int32) + node_offset
    coa_sum = jnp.sum(data, axis=0)
    return max_coa, max_coa * n_real / coa_sum, max_idx
