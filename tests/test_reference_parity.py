# -*- coding: utf-8 -*-
"""
Parity of the migration programs with the in-repo float64 reference
(quakemigrate_tpu.ops.reference), which restates the original C kernels'
semantics: clip at 0.01, log-domain mean over the available onsets,
first-index argmax, max * n / sum.

Every program is checked on the same cases: tile padding, a mid-grid node
slab, masked onsets, traveltimes outside the window (clamped), exact ties,
in float32 and float64.

"""

import numpy as np
import pytest

import jax

from quakemigrate_tpu.ops import reference
from quakemigrate_tpu.ops.migrate import (
    detect_reduce,
    find_max_coa,
    migrate_detect,
    migrate_detect_batch,
    migrate_map,
    migrate_marginalise,
)

CASES = ("tile_padding", "mid_grid_slab", "masked_onsets",
         "negative_traveltimes", "ties")
DTYPES = (np.float32, np.float64)
RTOL = {np.float32: 2e-6, np.float64: 1e-12}


def make_case(name, dtype, seed=0):
    """Small detect geometry exercising one edge of the contract."""

    rng = np.random.default_rng(seed + CASES.index(name))
    n_nodes, n_onsets, fsmp, nsamples, lsmp = 301, 5, 7, 48, 19
    onsets = rng.gamma(2.0, 1.5, size=(n_onsets, fsmp + nsamples + lsmp))
    onsets[:, ::11] = 0.001  # below the 0.01 clip
    tt = rng.integers(0, lsmp + 1, size=(n_nodes, n_onsets))
    mask = np.ones(n_onsets)
    if name == "masked_onsets":
        mask[[1, 3]] = 0.0
    elif name == "negative_traveltimes":
        tt = rng.integers(-6, lsmp + 7, size=(n_nodes, n_onsets))
    elif name == "ties":
        tt = tt[np.arange(n_nodes) % 7]  # every row repeats 43 times
    return dict(
        onsets=onsets.astype(dtype), tt=tt.astype(np.int32),
        mask=mask.astype(dtype), available=float(mask.sum()), fsmp=fsmp,
        nsamples=nsamples, tile=64,
        slab=(100, 200) if name == "mid_grid_slab" else None,
    )


def reference_detect(c, tt=None, samples=None):
    return reference.detect(
        c["onsets"].astype(np.float64), c["tt"] if tt is None else tt,
        c["fsmp"], c["nsamples"], c["available"], mask=c["mask"],
        samples=samples,
    )


def assert_detect_matches(got, c, dtype, tt=None):
    """max / normalised max within the dtype's tolerance; the argmax the
    reference's first index (float64) or a float32 near-tie."""

    tt = c["tt"] if tt is None else tt
    ref_coa, ref_norm, ref_idx = reference_detect(c, tt)
    max_coa, max_norm, max_idx = (np.asarray(a) for a in got)
    np.testing.assert_allclose(max_coa, ref_coa, rtol=RTOL[dtype])
    np.testing.assert_allclose(max_norm, ref_norm, rtol=10 * RTOL[dtype])
    local = max_idx.astype(np.int64)
    if dtype == np.float64:
        np.testing.assert_array_equal(local, ref_idx)
        return
    differ = np.flatnonzero(local != ref_idx)
    if differ.size:
        at = reference.coalescence_at(
            c["onsets"].astype(np.float64), tt, c["fsmp"], c["nsamples"],
            c["available"], local[differ], differ, mask=c["mask"],
        )
        assert np.all(ref_coa[differ] - at <= 1e-5 * ref_coa[differ])


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "f64"))
@pytest.mark.parametrize("case", CASES)
def test_migrate_detect_matches_reference(case, dtype):
    c = make_case(case, dtype)
    tt = c["tt"]
    if c["slab"] is not None:
        lo, hi = c["slab"]
        tt = tt[lo:hi]
    got = migrate_detect(
        c["onsets"], tt, c["mask"], c["available"], c["fsmp"],
        c["nsamples"], tile=c["tile"],
    )
    assert_detect_matches(got, c, dtype, tt=tt)


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "f64"))
def test_detect_reduce_mid_grid_slab_padding(dtype):
    """
    Tile padding appended to a MID-grid node slab must not alias real
    global indices: rows beyond the slab's true length are invalid even
    when their global index is < n_nodes_real. Two slabs of 100 rows (not
    a multiple of the tile) combined by hand equal the reference on the
    whole grid.

    """

    c = make_case("mid_grid_slab", dtype)
    tt = c["tt"][:200]
    parts = [
        [np.asarray(v) for v in detect_reduce(
            c["onsets"], tt[off:off + 100], c["mask"], c["available"],
            c["fsmp"], c["nsamples"], 200, tile=c["tile"], node_offset=off,
        )]
        for off in (0, 100)
    ]
    (m0, i0, s0), (m1, i1, s1) = parts
    better = m1 > m0
    max_coa = np.where(better, m1, m0)
    max_idx = np.where(better, i1, i0)
    got = (max_coa, max_coa * 200 / (s0 + s1), max_idx)
    assert_detect_matches(got, c, dtype, tt=tt)


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "f64"))
@pytest.mark.parametrize("case", CASES)
def test_migrate_map_matches_reference(case, dtype):
    c = make_case(case, dtype)
    tt = c["tt"] if c["slab"] is None else c["tt"][slice(*c["slab"])]
    got = np.asarray(migrate_map(
        c["onsets"], tt, c["mask"], c["available"], c["fsmp"],
        c["nsamples"], tile=c["tile"],
    ))
    want = reference.migrate(
        c["onsets"].astype(np.float64), tt, c["fsmp"], c["nsamples"],
        c["available"], mask=c["mask"],
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype])
    # find_max_coa over the retained map is the reference's reduction
    for a, b in zip(find_max_coa(got), reference.find_max_coa(want)):
        np.testing.assert_allclose(np.asarray(a), b, rtol=10 * RTOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "f64"))
@pytest.mark.parametrize("case", CASES)
def test_migrate_marginalise_matches_reference(case, dtype):
    """Marginalised over a window in the middle of the scan range; a
    masked sum, so float32 stays at float32 accuracy on every backend."""

    c = make_case(case, dtype)
    tt = c["tt"] if c["slab"] is None else c["tt"][slice(*c["slab"])]
    start, length = 9, 23
    got = np.asarray(migrate_marginalise(
        c["onsets"], tt, c["mask"], c["available"], c["fsmp"],
        c["nsamples"], start, length, tile=c["tile"],
    ))
    want = reference.marginalise(
        c["onsets"].astype(np.float64), tt, c["fsmp"], c["nsamples"],
        c["available"], start, length, mask=c["mask"],
    )
    np.testing.assert_allclose(got, want, rtol=10 * RTOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "f64"))
@pytest.mark.parametrize("case", CASES)
def test_sharded_detect_matches_reference(case, dtype):
    """The 8-device grid-sharded detect (collective max / first-index
    argmax / sum combine) against the reference."""

    from quakemigrate_tpu.parallel import (
        make_mesh,
        make_sharded_detect,
        pad_nodes_for_mesh,
    )

    c = make_case(case, dtype)
    tt = c["tt"] if c["slab"] is None else c["tt"][slice(*c["slab"])]
    mesh = make_mesh(jax.devices()[:8])
    padded, n_real = pad_nodes_for_mesh(tt, 8, tile=16)
    fn = make_sharded_detect(mesh, c["fsmp"], c["nsamples"], n_real,
                             tile=16)
    got = fn(c["onsets"], padded, c["mask"], c["available"])
    assert_detect_matches(got, c, dtype, tt=tt)


@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "f64"))
def test_migrate_detect_batch_matches_reference(dtype):
    """Each window of a batched call equals the reference on its own."""

    cases = [make_case(name, dtype, seed=5) for name in
             ("tile_padding", "masked_onsets", "ties")]
    tt = cases[0]["tt"]
    got = migrate_detect_batch(
        np.stack([c["onsets"] for c in cases]), tt,
        np.stack([c["mask"] for c in cases]),
        np.array([c["available"] for c in cases], dtype=dtype),
        cases[0]["fsmp"], cases[0]["nsamples"], tile=64,
    )
    for j, c in enumerate(cases):
        assert_detect_matches([g[j] for g in got], c, dtype, tt=tt)


def test_reference_detect_matches_full_map(monkeypatch):
    """The chunked reference reduction equals find_max_coa over the whole
    reference map, chunk boundaries and ties included."""

    monkeypatch.setattr(reference, "_chunk_rows", lambda n: 50)
    c = make_case("ties", np.float64)
    full = reference.find_max_coa(reference.migrate(
        c["onsets"], c["tt"], c["fsmp"], c["nsamples"], c["available"],
        mask=c["mask"],
    ))
    chunked = reference.detect(
        c["onsets"], c["tt"], c["fsmp"], c["nsamples"], c["available"],
        mask=c["mask"],
    )
    np.testing.assert_array_equal(chunked[0], full[0])
    np.testing.assert_allclose(chunked[1], full[1], rtol=1e-14)
    np.testing.assert_array_equal(chunked[2], full[2])
