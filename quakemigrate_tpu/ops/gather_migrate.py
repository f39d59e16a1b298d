# -*- coding: utf-8 -*-
"""
Fused migrate + grid reduction as one Pallas kernel (Triton route), the
detect reduction's GPU program.

Each program owns one block of ``bs`` scan samples and a contiguous group
of grid nodes, which it walks ``bn`` nodes at a time. For every onset it
loads the block's traveltime offsets and gathers the matching log-onset
segments straight from the onset rows (a few hundred KB, resident in L2),
so the stack accumulates in registers: no shift table and no coalescence
map is ever written to device memory. Each node block's exp, max,
first-index argmax and sum fold into a running reduction held per sample;
a small second pass in XLA combines the node groups.

Semantics are those of :func:`quakemigrate_tpu.ops.migrate.detect_reduce`
(traveltime offsets clamped to ``[0, lsmp]``, first index wins ties).

"""

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_BIG = jnp.iinfo(jnp.int32).max

# Nodes per register block. Measured on an H100 at the Icequake detect
# geometry (259,008 nodes x 24 onsets, 625 samples): 8 and 16 nodes took
# 2.20 and 2.28 ms, 32 nodes 2.54 ms, 64 nodes 4.94 ms.
NODE_BLOCK = 16
# Programs to aim for: several waves over the card's 132 SMs.
TARGET_PROGRAMS = 1024


def sample_block(nsamples):
    """Scan samples per program: 128, or 256 for day-scale windows (at
    30,000 samples, 16 x 256 blocks took 89 ms on an H100 against 100 ms
    for 32 x 128)."""

    return 256 if nsamples >= 4096 else 128


def _kernel(onsets_ref, tt_ref, inv_avail_ref, offset_ref, max_ref, idx_ref,
            sum_ref, *, n_onsets, t_len, fsmp, nsamples, d_max, n_valid,
            n_real, bn, bs, blocks_per_group):
    group = pl.program_id(0)
    s = jnp.minimum(pl.program_id(1) * bs + jnp.arange(bs, dtype=jnp.int32),
                    nsamples - 1)
    inv_avail = inv_avail_ref[0]
    node_offset = offset_ref[0]

    def node_block(k, carry):
        run_max, run_idx, run_sum = carry
        n0 = (group * blocks_per_group + k) * bn
        local = n0 + jnp.arange(bn, dtype=jnp.int32)
        acc = jnp.zeros((bn, bs), jnp.float32)
        for o in range(n_onsets):
            off = jnp.clip(tt_ref[o, pl.ds(n0, bn)], 0, d_max)
            acc = acc + onsets_ref[(o * t_len + fsmp) + off[:, None]
                                   + s[None, :]]
        glob = node_offset + local
        valid = (local < n_valid) & (glob < n_real)
        coa = jnp.where(valid[:, None], jnp.exp(acc * inv_avail), 0.0)
        block_max = jnp.max(coa, axis=0)
        block_arg = jnp.min(
            jnp.where(coa == block_max[None, :], glob[:, None], _BIG), axis=0
        )
        better = block_max > run_max  # strict: earlier blocks win ties
        return (
            jnp.where(better, block_max, run_max),
            jnp.where(better, block_arg, run_idx),
            run_sum + jnp.sum(coa, axis=0),
        )

    init = (
        jnp.full((bs,), -jnp.inf, jnp.float32),
        jnp.zeros((bs,), jnp.int32),
        jnp.zeros((bs,), jnp.float32),
    )
    max_ref[...], idx_ref[...], sum_ref[...] = jax.lax.fori_loop(
        0, blocks_per_group, node_block, init
    )


def gather_detect_reduce(onsets_log, traveltimes, available, fsmp, nsamples,
                         n_nodes_real, node_offset=0, bn=NODE_BLOCK, bs=None,
                         interpret=False):
    """
    (max_coa [S], max_idx [S], coa_sum [S]) over the node slab
    ``traveltimes`` [N, O] (global indices from ``node_offset``), from
    log-domain, mask-applied float32 onsets [O, T].

    """

    n_onsets, t_len = onsets_log.shape
    n_total = traveltimes.shape[0]
    bs = sample_block(nsamples) if bs is None else bs
    n_blocks = -(-n_total // bn)
    s_blocks = -(-nsamples // bs)
    n_groups = max(1, min(n_blocks, -(-TARGET_PROGRAMS // s_blocks)))
    blocks_per_group = -(-n_blocks // n_groups)
    n_pad = n_groups * blocks_per_group * bn
    s_pad = s_blocks * bs

    kernel = partial(
        _kernel, n_onsets=n_onsets, t_len=t_len, fsmp=fsmp,
        nsamples=nsamples, d_max=t_len - fsmp - nsamples, n_valid=n_total,
        n_real=n_nodes_real, bn=bn, bs=bs, blocks_per_group=blocks_per_group,
    )
    whole = pl.BlockSpec(memory_space=pl.ANY)
    part = pl.BlockSpec((None, bs), lambda g, s: (g, s))
    part_max, part_idx, part_sum = pl.pallas_call(
        kernel,
        grid=(n_groups, s_blocks),
        in_specs=[whole] * 4,
        out_specs=[part] * 3,
        out_shape=[
            jax.ShapeDtypeStruct((n_groups, s_pad), jnp.float32),
            jax.ShapeDtypeStruct((n_groups, s_pad), jnp.int32),
            jax.ShapeDtypeStruct((n_groups, s_pad), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4),
        interpret=interpret,
        name="qm_gather_detect",
    )(
        onsets_log.reshape(-1),
        jnp.pad(traveltimes.T, ((0, 0), (0, n_pad - n_total))),
        jnp.reshape(1.0 / jnp.asarray(available, jnp.float32), (1,)),
        jnp.reshape(jnp.asarray(node_offset, jnp.int32), (1,)),
    )
    # Node groups are in node order, so the first group attaining the max
    # holds the first node attaining it.
    best = jnp.argmax(part_max[:, :nsamples], axis=0)
    cols = jnp.arange(nsamples)
    return (part_max[best, cols], part_idx[best, cols],
            part_sum[:, :nsamples].sum(axis=0))
