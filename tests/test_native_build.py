# -*- coding: utf-8 -*-
"""
The native library is rebuilt from the committed C sources whenever no
build of exactly those sources exists: its file name carries a content
hash of the sources, the build flags and the host's machine type, so a
stale library (edited sources, or a copy from another host) is never
loaded.

"""

import importlib
import shutil

import pytest


@pytest.fixture
def core_copy(tmp_path, monkeypatch):
    """A private copy of the core package's sources and library dir."""

    import quakemigrate_tpu.core as core

    src = tmp_path / "src"
    shutil.copytree(core._SRC_DIR, src)
    lib = tmp_path / "lib"
    monkeypatch.setattr(core, "_SRC_DIR", src)
    monkeypatch.setattr(core, "_LIB_DIR", lib)
    return core, src, lib


def test_library_name_tracks_source_content(core_copy):
    core, src, _ = core_copy
    before = core._source_hash()
    assert before == core._source_hash()  # deterministic
    path = src / core._SOURCES[0]
    path.write_text(path.read_text() + "\n/* edited */\n")
    assert core._source_hash() != before


def test_stale_library_is_replaced_not_loaded(core_copy, monkeypatch):
    if shutil.which("cc") is None:
        pytest.skip("no C compiler")
    core, src, lib = core_copy
    lib.mkdir()
    stale = lib / "libqmtpu-0000000000000000.so"
    stale.write_bytes(b"not a library built from these sources")
    monkeypatch.setattr(
        core, "_LIB_PATH", lib / f"libqmtpu-{core._source_hash()}.so"
    )
    assert core._load_library() is not None
    assert core._LIB_PATH.is_file()
    assert not stale.exists()
    assert sorted(p.name for p in lib.iterdir()) == [core._LIB_PATH.name]


def test_loaded_library_matches_current_sources():
    core = importlib.import_module("quakemigrate_tpu.core")
    assert core.native_available()
    assert core._LIB_PATH.name == f"libqmtpu-{core._source_hash()}.so"
