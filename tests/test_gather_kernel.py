# -*- coding: utf-8 -*-
"""
The detect reduction's GPU kernel (ops.gather_migrate): its arithmetic in
Pallas interpret mode on the CPU against the float64 reference, the block
and padding choices made from the input's shapes, and -- on a machine
with a GPU (``-m gpu``) -- the compiled kernel at the Icequake width.

"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from quakemigrate_tpu.ops import gather_migrate, reference
from quakemigrate_tpu.ops.migrate import _prepare_onsets

CASES = {
    # name: (n_nodes, n_onsets, nsamples, lsmp, node_offset, n_real, bs)
    "one_block": (16, 3, 32, 9, 0, 16, 32),
    "node_padding": (101, 4, 40, 11, 0, 101, 32),
    "sample_padding": (64, 4, 45, 11, 0, 64, 32),
    "mid_grid_slab": (50, 4, 40, 11, 50, 130, 32),
    "tail_slab": (50, 4, 40, 11, 100, 130, 32),
    "many_groups": (700, 3, 33, 8, 0, 700, 16),
}


def run_case(name, seed=0):
    n_nodes, n_onsets, nsamples, lsmp, offset, n_real, bs = CASES[name]
    rng = np.random.default_rng(seed)
    fsmp = 5
    onsets = rng.gamma(2.0, 1.5, size=(n_onsets, fsmp + nsamples + lsmp))
    tt = rng.integers(-2, lsmp + 3, size=(n_nodes, n_onsets)).astype(np.int32)
    mask = np.ones(n_onsets)
    mask[-1] = 0.0
    logged = _prepare_onsets(jnp.asarray(onsets, jnp.float32),
                             jnp.asarray(mask, jnp.float32))
    got = gather_migrate.gather_detect_reduce(
        logged, jnp.asarray(tt), mask.sum(), fsmp, nsamples, n_real,
        node_offset=offset, bn=8, bs=bs, interpret=True,
    )
    onsets32 = onsets.astype(np.float32).astype(np.float64)
    valid = offset + np.arange(n_nodes) < n_real
    ref = reference.detect(onsets32, tt[valid], fsmp, nsamples, mask.sum(),
                           mask=mask)
    return [np.asarray(g) for g in got], ref, offset


@pytest.mark.parametrize("name", sorted(CASES))
def test_gather_kernel_matches_reference_interpret(name):
    (max_coa, max_idx, coa_sum), (ref_max, ref_norm, ref_idx), offset = (
        run_case(name)
    )
    n_real_here = len(np.flatnonzero(
        offset + np.arange(CASES[name][0]) < CASES[name][5]
    ))
    np.testing.assert_allclose(max_coa, ref_max, rtol=2e-6)
    np.testing.assert_array_equal(max_idx, ref_idx + offset)
    np.testing.assert_allclose(max_coa * n_real_here / coa_sum, ref_norm,
                               rtol=2e-6)


def test_gather_kernel_first_index_wins_ties_interpret():
    """Identical traveltime rows tie exactly; the lowest node index wins,
    across register blocks and across node groups."""

    rng = np.random.default_rng(3)
    n_onsets, fsmp, nsamples, lsmp = 3, 4, 24, 6
    onsets = rng.gamma(2.0, 1.5, size=(n_onsets, fsmp + nsamples + lsmp))
    tt = np.tile(rng.integers(0, lsmp, size=(1, n_onsets)), (200, 1))
    logged = _prepare_onsets(jnp.asarray(onsets, jnp.float32),
                             jnp.ones(n_onsets, jnp.float32))
    _, idx, _ = gather_migrate.gather_detect_reduce(
        logged, jnp.asarray(tt, jnp.int32), float(n_onsets), fsmp,
        nsamples, 200, node_offset=7, bn=8, bs=8, interpret=True,
    )
    np.testing.assert_array_equal(np.asarray(idx), 7)


@pytest.mark.parametrize("nsamples, want", [(1, 128), (625, 128),
                                            (4095, 128), (4096, 256),
                                            (30000, 256)])
def test_sample_block_follows_window_length(nsamples, want):
    assert gather_migrate.sample_block(nsamples) == want


def test_kernel_grid_covers_nodes_and_samples():
    """The launch grid and padding are chosen from the shapes: every node
    block and sample block is covered, with about TARGET_PROGRAMS
    programs for a full-size window."""

    seen = {}

    def fake_pallas_call(kernel, grid, out_shape, **kwargs):
        seen["grid"] = grid

        def run(onsets, tt, inv_avail, offset):
            seen["tt"] = tt.shape
            return [jnp.zeros(s.shape, s.dtype) for s in out_shape]

        return run

    n_nodes, nsamples = 259_008, 625
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gather_migrate.pl, "pallas_call", fake_pallas_call)
        gather_migrate.gather_detect_reduce(
            jnp.zeros((24, 1675), jnp.float32),
            jnp.zeros((n_nodes, 24), jnp.int32), 24.0, 475, nsamples,
            n_nodes,
        )
    groups, s_blocks = seen["grid"]
    assert s_blocks * 128 >= nsamples > (s_blocks - 1) * 128
    padded = seen["tt"][1]
    assert seen["tt"][0] == 24 and padded >= n_nodes
    assert padded % (groups * gather_migrate.NODE_BLOCK) == 0
    assert padded - n_nodes < groups * gather_migrate.NODE_BLOCK
    assert 0.9 * gather_migrate.TARGET_PROGRAMS <= groups * s_blocks <= (
        1.1 * gather_migrate.TARGET_PROGRAMS
    )


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time)."""

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: the Triton kernel has no CPU lowering")
    return jax.devices()[0]


@pytest.mark.gpu
def test_compiled_kernel_matches_reference_at_icequake_width(gpu):
    import bench

    onsets, tt4d = bench.make_workload()
    tt = np.ascontiguousarray(tt4d.reshape(-1, bench.N_ONSETS))
    n_onsets = bench.N_ONSETS
    mask = jnp.ones(n_onsets, jnp.float32)
    logged = _prepare_onsets(jnp.asarray(onsets, jnp.float32), mask)
    max_coa, max_idx, coa_sum = gather_migrate.gather_detect_reduce(
        logged, jnp.asarray(tt), float(n_onsets), bench.FSMP,
        bench.NSAMPLES, tt.shape[0],
    )
    ref_max, ref_norm, _ = reference.detect(
        onsets.astype(np.float32).astype(np.float64), tt, bench.FSMP,
        bench.NSAMPLES, float(n_onsets),
    )
    np.testing.assert_allclose(np.asarray(max_coa), ref_max, rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(max_coa) * tt.shape[0] / np.asarray(coa_sum), ref_norm,
        rtol=1e-5,
    )


@pytest.mark.gpu
def test_compiled_kernel_batched_matches_single_windows(gpu):
    """migrate_detect_batch vmaps the kernel over windows (a batched
    Pallas grid); each window equals its own single call."""

    from quakemigrate_tpu.ops.migrate import (
        migrate_detect,
        migrate_detect_batch,
    )

    rng = np.random.default_rng(9)
    n_onsets, fsmp, nsamples, lsmp = 8, 30, 300, 40
    onsets = rng.gamma(2.0, 1.5, size=(3, n_onsets, fsmp + nsamples + lsmp))
    onsets = onsets.astype(np.float32)
    tt = rng.integers(0, lsmp, size=(5000, n_onsets)).astype(np.int32)
    masks = np.ones((3, n_onsets), np.float32)
    masks[1, 2] = 0.0
    avail = masks.sum(axis=1)
    batched = migrate_detect_batch(onsets, tt, masks, avail, fsmp, nsamples)
    for j in range(3):
        single = migrate_detect(onsets[j], tt, masks[j], float(avail[j]),
                                fsmp, nsamples)
        for b, s in zip(batched, single):
            np.testing.assert_allclose(np.asarray(b[j]), np.asarray(s),
                                       rtol=1e-6)
