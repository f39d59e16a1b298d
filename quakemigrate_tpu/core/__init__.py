# -*- coding: utf-8 -*-
"""
Native (C) compute core for quakemigrate_tpu's host-side subsystems.

Provides ctypes bindings to:
- STEIM1/STEIM2 miniSEED codecs (steimlib.c) -- the detect stage streams
  day-length int32 coalescence traces to .scanmseed, so encode/decode is on
  the host throughput path.
- A fast-marching eikonal solver (fmmlib.c) for traveltime LUT generation.

The shared library is compiled on first import whenever no build of the
current sources exists (its file name carries their content hash); the
STEIM codec falls back to pure Python if no compiler is available, which
:func:`native_available` reports.

The device compute path (migration/stacking, onset functions)
intentionally does NOT live here -- it is implemented as JAX/Pallas
programs in quakemigrate_tpu.ops.

"""

import ctypes
import hashlib
import logging
import os
import pathlib
import platform
import subprocess
import sys

import numpy as np
import numpy.ctypeslib as clib

_SRC_DIR = pathlib.Path(__file__).parent / "src"
_LIB_DIR = pathlib.Path(__file__).parent / "lib"

_SOURCES = ["steimlib.c", "fmmlib.c"]
# The STEIM codec's difference/accumulator arithmetic relies on int32
# wraparound, which is UB without -fwrapv.
_CFLAGS = ["-O2", "-fwrapv", "-shared", "-fPIC"]


def _source_hash():
    """Content hash of the sources, the build flags and the host's
    machine type: the library's name carries it, so a library built from
    other sources (or copied from another kind of host) is never loaded."""

    digest = hashlib.sha256()
    for name in _SOURCES:
        digest.update(name.encode())
        digest.update((_SRC_DIR / name).read_bytes())
    digest.update(" ".join(_CFLAGS).encode())
    digest.update(f"{sys.platform}-{platform.machine()}".encode())
    return digest.hexdigest()[:16]


_LIB_PATH = _LIB_DIR / f"libqmtpu-{_source_hash()}.so"


def _build_library():
    """Compile the native sources into ``_LIB_PATH``; drop stale builds."""

    _LIB_DIR.mkdir(exist_ok=True)
    sources = [str(_SRC_DIR / s) for s in _SOURCES]
    tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
    for compiler in ("cc", "gcc", "clang"):
        cmd = [compiler, *_CFLAGS, "-o", str(tmp), *sources, "-lm"]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as exc:
            logging.debug(f"Native build with {compiler} failed: {exc}")
            continue
        # Atomic: a concurrent importer sees either no library or all of it
        os.replace(tmp, _LIB_PATH)
        for stale in _LIB_DIR.glob("libqmtpu*.so"):
            if stale != _LIB_PATH:
                stale.unlink(missing_ok=True)
        return True
    return False


def _load_library():
    if not _LIB_PATH.exists() and not _build_library():
        return None
    try:
        return ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None


_lib = _load_library()

c_u8p = clib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
c_i32p = clib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
c_f64p = clib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
c_i64 = ctypes.c_int64
c_i32 = ctypes.c_int32
c_f64 = ctypes.c_double

if _lib is not None:
    for name in ("steim1_decode", "steim2_decode"):
        fn = getattr(_lib, name)
        fn.argtypes = [c_u8p, c_i64, c_i64, c_i32p, ctypes.c_int]
        fn.restype = c_i64
    for name in ("steim1_encode", "steim2_encode"):
        fn = getattr(_lib, name)
        fn.argtypes = [
            c_i32p,
            c_i64,
            c_i32,
            c_u8p,
            c_i64,
            ctypes.POINTER(c_i64),
        ]
        fn.restype = c_i64
    _lib.steim_decode_records.argtypes = [
        c_u8p, clib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS"),
        clib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS"), c_u8p,
        c_i64, c_i64, c_i64, ctypes.c_int, c_i32p,
    ]
    _lib.steim_decode_records.restype = c_i64
    _lib.steim_encode_records.argtypes = [
        c_i32p, c_i64, c_i64, ctypes.c_int, c_u8p, c_i64,
        clib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS"), c_u8p,
    ]
    _lib.steim_encode_records.restype = c_i64
    _lib.fast_marching.argtypes = [
        c_f64p,
        c_i64,
        c_i64,
        c_i64,
        c_f64,
        c_f64,
        c_f64,
        c_f64,
        c_f64,
        c_f64,
        ctypes.c_int,
        c_f64p,
    ]
    _lib.fast_marching.restype = ctypes.c_int


def native_available():
    """Whether the compiled native library is loaded."""

    return _lib is not None


def steim_decode(frames, nsamples, encoding, little_endian=False):
    """
    Decode STEIM1/2 frames (bytes or uint8 array) into int32 samples.
    ``encoding`` is the SEED code: 10 for STEIM1, 11 for STEIM2. Set
    ``little_endian`` for payloads whose Blockette-1000 word order is 0
    (non-standard but common in the wild).

    """

    frames = np.frombuffer(bytes(frames), dtype=np.uint8)
    nframes = len(frames) // 64
    out = np.empty(nsamples, dtype=np.int32)
    if _lib is not None:
        fn = _lib.steim2_decode if encoding == 11 else _lib.steim1_decode
        n = fn(frames, nframes, nsamples, out, 1 if little_endian else 0)
    else:
        from . import steim_py

        n = steim_py.decode(frames, nframes, nsamples, out, encoding,
                            little_endian=little_endian)
    if n < 0:
        raise ValueError("Malformed STEIM data.")
    if n < nsamples:
        raise ValueError(
            f"STEIM decode produced {n} of {nsamples} expected samples."
        )
    return out


def steim_encode(samples, prev, nframes, encoding):
    """
    Encode int32 ``samples`` into up to ``nframes`` STEIM frames.

    Returns (nsamples_consumed, frame_bytes). Raises ValueError if a STEIM2
    difference overflows 30 bits (callers fall back to STEIM1).

    """

    samples = np.ascontiguousarray(samples, dtype=np.int32)
    out = np.zeros(nframes * 64, dtype=np.uint8)
    used = c_i64(0)
    if _lib is not None:
        fn = _lib.steim2_encode if encoding == 11 else _lib.steim1_encode
        n = fn(samples, len(samples), c_i32(int(prev)), out, nframes, ctypes.byref(used))
        nframes_used = used.value
    else:
        from . import steim_py

        n, nframes_used = steim_py.encode(samples, int(prev), out, nframes, encoding)
    if n < 0:
        raise ValueError("STEIM2 difference overflow; fall back to STEIM1.")
    return int(n), out[: nframes_used * 64].tobytes()


def steim_decode_records(buf, offsets, npts, enc, data_offset, reclen,
                         little_endian=False):
    """
    Decode a batch of same-geometry miniSEED records in ONE native call
    (the per-record Python/ctypes round-trip dominates day-file reads).
    ``buf`` is the raw file bytes; ``offsets``/``npts``/``enc`` are
    per-record arrays (enc: SEED code 10/11 per record — STEIM2 files may
    contain per-record STEIM1 fallbacks). Returns the concatenated int32
    samples. Raises ValueError naming the failing record if any record is
    malformed or under-produces (callers fall back to the per-record
    path, which logs and skips it).

    """

    buf = np.frombuffer(buf, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    npts = np.ascontiguousarray(npts, dtype=np.int64)
    enc = np.ascontiguousarray(enc, dtype=np.uint8)
    out = np.empty(int(npts.sum()), dtype=np.int32)
    if _lib is not None:
        n = _lib.steim_decode_records(
            buf, offsets, npts, enc, len(offsets), int(data_offset),
            int(reclen), 1 if little_endian else 0, out,
        )
        if n < 0:
            raise ValueError(f"Malformed STEIM data in record {-n - 1}.")
    else:
        pos = 0
        for r in range(len(offsets)):
            lo = int(offsets[r]) + int(data_offset)
            want = int(npts[r])
            out[pos:pos + want] = steim_decode(
                buf[lo:int(offsets[r]) + int(reclen)].tobytes(), want,
                int(enc[r]), little_endian=little_endian,
            )
            pos += want
    return out


def steim_encode_records(samples, nframes, encoding):
    """
    Pack a whole int32 array into consecutive records' frame payloads in
    ONE native call. Returns (payloads [n_records, nframes*64] uint8,
    consumed [n_records] int64, rec_enc [n_records] uint8) — rec_enc
    holds 10 where a STEIM2 record fell back to STEIM1.

    """

    samples = np.ascontiguousarray(samples, dtype=np.int32)
    frame_bytes = int(nframes) * 64
    # Worst case one sample per data word: 13 words in frame 0 (words
    # 0-2 are ctrl + integration constants), 15 in every later frame.
    min_per_record = 13 + (int(nframes) - 1) * 15
    max_records = max(1, -(-len(samples) // min_per_record))
    out = np.zeros(max_records * frame_bytes, dtype=np.uint8)
    consumed = np.zeros(max_records, dtype=np.int64)
    rec_enc = np.zeros(max_records, dtype=np.uint8)
    if _lib is not None:
        n = _lib.steim_encode_records(
            samples, len(samples), int(nframes), int(encoding), out,
            max_records, consumed, rec_enc,
        )
        if n < 0:
            raise ValueError("steim_encode_records: record budget exceeded")
    else:
        pos, n = 0, 0
        while pos < len(samples):
            prev = samples[pos - 1] if pos else samples[pos]
            try:
                c, payload = steim_encode(
                    samples[pos:], prev, int(nframes), encoding
                )
                e = encoding
            except ValueError:
                c, payload = steim_encode(samples[pos:], prev, int(nframes), 10)
                e = 10
            row = np.frombuffer(payload, dtype=np.uint8)
            out[n * frame_bytes : n * frame_bytes + len(row)] = row
            consumed[n], rec_enc[n] = c, e
            pos += c
            n += 1
    return (
        out[: n * frame_bytes].reshape(n, frame_bytes),
        consumed[:n],
        rec_enc[:n],
    )


def fast_marching(velocity, spacing, source_index, order=2):
    """
    Solve |grad T| = 1/v from a point source on a regular grid.

    Parameters
    ----------
    velocity : ndarray, 1-D, 2-D or 3-D
        Velocity at each grid node (grid-projection units per second).
    spacing : sequence of float
        Node spacing per dimension (same units as velocity distances).
    source_index : sequence of float
        Source position in fractional grid-index coordinates.
    order : int
        Upwind stencil order (1 or 2).

    Returns
    -------
    traveltimes : ndarray, same shape as velocity.

    """

    velocity = np.ascontiguousarray(velocity, dtype=np.float64)
    shape = velocity.shape
    # Promote to 3-D with trailing singleton dimensions
    full_shape = tuple(shape) + (1,) * (3 - velocity.ndim)
    spacing = list(np.atleast_1d(spacing).astype(float)) + [1.0] * (3 - velocity.ndim)
    source = list(np.atleast_1d(source_index).astype(float)) + [0.0] * (
        3 - velocity.ndim
    )
    vel3 = velocity.reshape(full_shape)
    tt = np.empty(full_shape, dtype=np.float64)

    if _lib is None:
        raise RuntimeError(
            "Native library unavailable: fast_marching requires the compiled "
            "core (no C compiler found)."
        )

    status = _lib.fast_marching(
        np.ascontiguousarray(vel3),
        *[c_i64(s) for s in full_shape],
        *[c_f64(s) for s in spacing],
        *[c_f64(s) for s in source],
        ctypes.c_int(order),
        tt,
    )
    if status != 0:
        raise MemoryError("fast_marching failed to allocate working memory.")

    return tt.reshape(shape)


# Reference-shaped bindings for the device kernels (reference
# core/lib.py:52-285): numpy-in/numpy-out wrappers over the JAX ops so
# scripts written against quakemigrate.core run unchanged.
from quakemigrate_tpu.core.compat import (  # noqa: E402,F401
    centred_sta_lta,
    find_max_coa,
    migrate,
    overlapping_sta_lta,
    recursive_sta_lta,
)
