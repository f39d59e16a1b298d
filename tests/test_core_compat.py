# -*- coding: utf-8 -*-
"""
Behavioral parity for the reference-shaped core bindings
(quakemigrate_tpu.core.compat): scripts written against the reference's
``quakemigrate.core`` API (reference core/lib.py:52-285) must get the
same numbers from this package's wrappers — raw-onset in, 4-D float64
map out — not just the same signatures (which tests/test_api_parity.py
already pins).

The oracle is the reference C library compiled at test time
(tests/oracle.py). The wrappers feed float32 device kernels, so
tolerances are float32-level rather than the 1e-12 used for the
float64-path op tests.

"""

import numpy as np
import pytest

from oracle import (
    load_oracle,
    oracle_find_max_coa,
    oracle_migrate,
    oracle_sta_lta,
)

from quakemigrate_tpu.core import compat

pytestmark = pytest.mark.skipif(
    load_oracle() is None, reason="reference oracle unavailable"
)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(7)
    grid, n_onsets, fsmp, lsmp, nsamples = (4, 3, 5), 6, 20, 30, 120
    t_samples = nsamples + fsmp + lsmp
    onsets = rng.gamma(2.0, 1.5, size=(n_onsets, t_samples))
    traveltimes = rng.integers(
        0, lsmp, size=grid + (n_onsets,)
    ).astype(np.int32)
    return onsets, traveltimes, fsmp, lsmp


def test_migrate_matches_reference_binding(problem):
    onsets, traveltimes, fsmp, lsmp = problem
    available = onsets.shape[0]

    ours = compat.migrate(onsets, traveltimes, fsmp, lsmp, available)
    ref = oracle_migrate(onsets, traveltimes, fsmp, lsmp, available)

    assert ours.shape == ref.shape
    assert ours.dtype == np.float64
    np.testing.assert_allclose(ours, ref, rtol=5e-5)


def test_migrate_validations(problem):
    onsets, traveltimes, fsmp, lsmp = problem
    with pytest.raises(ValueError, match="Mismatch"):
        compat.migrate(onsets[:-1], traveltimes, fsmp, lsmp, 5)
    with pytest.raises(ValueError, match="smaller"):
        # A negative post-pad inflates the claimed scan length past the
        # data actually supplied (the reference binding's size guard,
        # reference core/lib.py:105-110).
        compat.migrate(onsets, traveltimes, fsmp,
                       -(onsets.size + 1), onsets.shape[0])


def test_find_max_coa_matches_reference_binding(problem):
    onsets, traveltimes, fsmp, lsmp = problem
    map4d = oracle_migrate(onsets, traveltimes, fsmp, lsmp, onsets.shape[0])

    mx, norm, idx = compat.find_max_coa(map4d)
    ref_mx, ref_norm, ref_idx = oracle_find_max_coa(map4d)

    assert idx.dtype == np.int64
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(mx, ref_mx, rtol=5e-5)
    np.testing.assert_allclose(norm, ref_norm, rtol=5e-5)


@pytest.mark.parametrize("kind", [
    "overlapping_sta_lta", "centred_sta_lta", "recursive_sta_lta",
])
def test_sta_lta_matches_reference_binding(kind):
    rng = np.random.default_rng(3)
    signal = rng.normal(size=2000) ** 2

    ours = getattr(compat, kind)(signal, 10, 100)
    ref = oracle_sta_lta(signal, 10, 100, position=kind.split("_")[0])

    assert ours.dtype == np.float64
    np.testing.assert_allclose(ours, ref, rtol=2e-4, atol=1e-6)
