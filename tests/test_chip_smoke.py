# -*- coding: utf-8 -*-
"""
The CPU-testable parts of chip_smoke.py: argument parsing, the exact last
line, refusing to run without a GPU or outside a checkout, the window
parity check and the trigger matching. The phases themselves need a GPU.

"""

import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


@pytest.mark.parametrize("argv, four", [([], False),
                                        (["--four-cards"], True)])
def test_parse_args(argv, four):
    assert chip_smoke.parse_args(argv).four_cards is four


def test_parse_args_rejects_unknown_option():
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--cpu"])


def test_result_line_is_exact():
    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    '"NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1


def test_gpu_devices_refuses_cpu():
    import jax

    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU"):
        chip_smoke.gpu_devices(jax, 1)


def test_gpu_devices_needs_enough_cards():
    gpu = types.SimpleNamespace(platform="gpu")
    fake = types.SimpleNamespace(devices=lambda: [gpu])
    assert chip_smoke.gpu_devices(fake, 1) == [gpu]
    with pytest.raises(chip_smoke.SmokeFailure, match="need 4"):
        chip_smoke.gpu_devices(fake, 4)


def test_main_fails_without_gpu_and_prints_no_result(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_script_alone_fails_and_prints_no_result(tmp_path):
    """Copied alone into an empty directory, the script exits non-zero
    before importing anything of the repository."""

    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _window(n=8, seed=0):
    rng = np.random.default_rng(seed)
    coa = rng.uniform(1.0, 2.0, n)
    return coa, coa * 3.0, np.arange(n)


@pytest.mark.parametrize("bend, ok", [
    (lambda got: got, True),
    (lambda got: (got[0] * (1 + 5e-6), got[1], got[2]), True),
    (lambda got: (got[0] * (1 + 5e-5), got[1], got[2]), False),
    (lambda got: (got[0], got[1] * (1 - 5e-5), got[2]), False),
    (lambda got: (got[0], got[1], got[2] + 1), True),   # ties
])
def test_check_window_tolerances(bend, ok):
    ref = _window()
    got = bend(ref)
    # the reference value at a different node: a tie within 1e-6
    ref_at = lambda nodes, cols: ref[0][cols] * (1 - 1e-6)  # noqa: E731
    if ok:
        chip_smoke.check_window("w", got, ref, ref_at)
    else:
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.check_window("w", got, ref, ref_at)


def test_check_window_rejects_non_tie_argmax():
    ref = _window()
    got = (ref[0], ref[1], ref[2] + 1)
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_window(
            "w", got, ref, lambda nodes, cols: ref[0][cols] * 0.99
        )


def test_match_triggers_finds_missed_and_false():
    from quakemigrate_tpu.seis import UTCDateTime

    start = UTCDateTime("2014-06-29T00:01:00")
    span = (start, start + 600)
    planted = [(start + 100, [0, 0, 0]), (start + 300, [0, 0, 0])]
    table = {"CoaTime": [str(start + 100.4), str(start + 450)]}
    missed, false = chip_smoke.match_triggers(planted, table, span)
    assert [str(t) for t in missed] == [str(start + 300)]
    assert [str(t) for t in false] == [str(start + 450)]
