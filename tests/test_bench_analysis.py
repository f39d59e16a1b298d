# -*- coding: utf-8 -*-
"""
Unit tests for bench.py's host-side protocol: the parity gate against
the float64 reference (tie-consistent argmax), the timing loop (every
call ends in block_until_ready, compilation excluded) and the refusal to
measure anything but a GPU. The timings themselves come from running
bench.py on the card.

"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench  # noqa: E402


def _ref(n=16):
    return np.full(n, 2.0), np.full(n, 3.0), np.zeros(n, dtype=np.int64)


@pytest.mark.parametrize("value_at, ok", [
    (lambda idx, t: np.full(len(t), 2.0 * (1 - 1e-6)), True),  # a tie
    (lambda idx, t: np.full(len(t), 2.0 * 0.99), False),       # not a tie
])
def test_parity_gate_tie_consistency(value_at, ok):
    """The argmax contract is tie-consistency, not node identity: a far
    node whose reference value is within 1e-5 of the max passes, one
    materially below it fails."""

    ref_coa, ref_norm, ref_idx = _ref()
    out = (ref_coa * (1 + 2e-6), ref_norm, np.full(16, 5000, np.int32))
    gate = bench.parity_gate(out, ref_coa, ref_norm, ref_idx, value_at)
    assert gate["parity_ok"] is ok
    assert gate["argmax_differs"] == 16


@pytest.mark.parametrize("scale_coa, scale_norm", [(1 + 2e-5, 1.0),
                                                   (1.0, 1 - 2e-5)])
def test_parity_gate_rejects_values_beyond_tolerance(scale_coa, scale_norm):
    ref_coa, ref_norm, ref_idx = _ref()
    out = (ref_coa * scale_coa, ref_norm * scale_norm, ref_idx)
    gate = bench.parity_gate(out, ref_coa, ref_norm, ref_idx, None)
    assert not gate["parity_ok"]
    assert gate["argmax_differs"] == 0


def test_time_calls_blocks_every_call_and_skips_warmup(monkeypatch):
    import jax

    clock = {"t": 0.0}
    blocked = []
    monkeypatch.setattr(bench.time, "perf_counter", lambda: clock["t"])
    monkeypatch.setattr(jax, "block_until_ready", blocked.append)

    def fn(block):
        clock["t"] += {"a": 0.003, "b": 0.001}[block]
        return block

    best, median = bench.time_calls(fn, ["a", "b"], reps=4)
    # warm-up "a" + a, b, a, b -- every call blocked
    assert blocked == ["a", "a", "b", "a", "b"]
    assert best == pytest.approx(0.001)
    assert median == pytest.approx(0.002)


def test_require_gpu_refuses_cpu():
    import jax

    with pytest.raises(SystemExit, match="GPU"):
        bench.require_gpu(jax)
    gpu = types.SimpleNamespace(platform="gpu")
    assert bench.require_gpu(
        types.SimpleNamespace(devices=lambda: [gpu])
    ) is gpu


def test_workload_geometry():
    onsets, tt4d = bench.make_workload(dims=(6, 5, 4))
    assert onsets.shape == (bench.N_ONSETS,
                            bench.NSAMPLES + bench.FSMP + bench.LSMP)
    assert tt4d.shape == (6, 5, 4, bench.N_ONSETS)
    assert tt4d.min() >= 0 and tt4d.max() <= bench.LSMP
