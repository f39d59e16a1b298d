# -*- coding: utf-8 -*-
"""
Plain float64 reference for the migration kernels, in numpy.

It restates the semantics of the original C kernels ``migrate`` and
``find_max_coa`` (QuakeMigrate's migratelib.c) without sharing code with
the device path, so tests and the chip smoke check can hold the JAX
programs to it:

- onsets are clipped at 0.01 and taken to the log domain;
- a node's coalescence at scan sample ``s`` is the exponential of the
  mean, over the ``available`` live onsets, of the log onset at sample
  ``fsmp + tt + s``; masked (dead) onset rows contribute nothing;
- per sample, the maximum over nodes, the FIRST node index attaining it,
  and the normalised maximum ``max * n_nodes / sum``.

Traveltime offsets are clamped to ``[0, lsmp]``, the range the scan
window can hold (the device programs clamp the same way; real lookup
tables never leave it).

The grid is processed in node chunks, so a full-size detect window
(hundreds of thousands of nodes) runs on the host in bounded memory.

"""

import numpy as np

MIN_ONSET_CLIP = 0.01


def _log_onsets(onsets, mask):
    logged = np.log(np.clip(np.asarray(onsets, dtype=np.float64),
                            MIN_ONSET_CLIP, None))
    if mask is not None:
        logged = logged * np.asarray(mask, dtype=np.float64)[:, None]
    return logged


def _chunk_coalescence(logged, tt, fsmp, nsamples, available, samples):
    """[n, len(samples)] coalescence of the nodes in ``tt`` [n, O]."""

    lsmp = logged.shape[1] - fsmp - nsamples
    offsets = np.clip(tt.astype(np.int64), 0, lsmp)
    stack = np.zeros((tt.shape[0], len(samples)), dtype=np.float64)
    for o in range(logged.shape[0]):
        cols = fsmp + offsets[:, o][:, None] + samples[None, :]
        stack += logged[o][cols]
    return np.exp(stack / available)


def _chunk_rows(n_samples, budget=1 << 22):
    """Nodes per chunk so one chunk holds about ``budget`` values."""

    return max(1, budget // max(1, n_samples))


def migrate(onsets, traveltimes, fsmp, nsamples, available, mask=None,
            samples=None):
    """
    The coalescence map [N, S] (or [N, len(samples)] for a subset of scan
    samples). ``traveltimes`` is [N, O] in samples.

    """

    logged = _log_onsets(onsets, mask)
    tt = np.asarray(traveltimes)
    samples = (np.arange(nsamples) if samples is None
               else np.asarray(samples, dtype=np.int64))
    out = np.empty((tt.shape[0], len(samples)), dtype=np.float64)
    chunk = _chunk_rows(len(samples))
    for lo in range(0, tt.shape[0], chunk):
        out[lo:lo + chunk] = _chunk_coalescence(
            logged, tt[lo:lo + chunk], fsmp, nsamples, available, samples
        )
    return out


def find_max_coa(map_flat):
    """(max_coa, max_norm_coa, max_idx) over the node axis of [N, S]."""

    max_coa = map_flat.max(axis=0)
    max_idx = np.argmax(map_flat, axis=0)  # first index attaining the max
    return max_coa, max_coa * map_flat.shape[0] / map_flat.sum(axis=0), max_idx


def detect(onsets, traveltimes, fsmp, nsamples, available, mask=None,
           samples=None):
    """
    ``find_max_coa(migrate(...))`` without holding the whole map: the
    per-sample maximum, normalised maximum and first-index argmax, reduced
    chunk by chunk. Returns float64 / int64 arrays over ``samples``.

    """

    logged = _log_onsets(onsets, mask)
    tt = np.asarray(traveltimes)
    n_nodes = tt.shape[0]
    samples = (np.arange(nsamples) if samples is None
               else np.asarray(samples, dtype=np.int64))
    max_coa = np.full(len(samples), -np.inf)
    max_idx = np.zeros(len(samples), dtype=np.int64)
    total = np.zeros(len(samples))
    chunk = _chunk_rows(len(samples))
    for lo in range(0, n_nodes, chunk):
        coa = _chunk_coalescence(
            logged, tt[lo:lo + chunk], fsmp, nsamples, available, samples
        )
        chunk_max = coa.max(axis=0)
        better = chunk_max > max_coa  # strict: earlier chunks win ties
        max_idx = np.where(better, lo + np.argmax(coa, axis=0), max_idx)
        max_coa = np.where(better, chunk_max, max_coa)
        total += coa.sum(axis=0)
    return max_coa, max_coa * n_nodes / total, max_idx


def marginalise(onsets, traveltimes, fsmp, nsamples, available,
                window_start, window_length, mask=None):
    """Coalescence summed over scan samples [start, start + length): [N]."""

    samples = np.arange(window_start, min(window_start + window_length,
                                          nsamples))
    return migrate(onsets, traveltimes, fsmp, nsamples, available,
                   mask=mask, samples=samples).sum(axis=1)


def coalescence_at(onsets, traveltimes, fsmp, nsamples, available, nodes,
                   samples, mask=None):
    """Coalescence of node ``nodes[k]`` at scan sample ``samples[k]``."""

    logged = _log_onsets(onsets, mask)
    lsmp = logged.shape[1] - fsmp - nsamples
    offsets = np.clip(np.asarray(traveltimes)[np.asarray(nodes)]
                      .astype(np.int64), 0, lsmp)
    cols = fsmp + offsets + np.asarray(samples, dtype=np.int64)[:, None]
    rows = np.arange(logged.shape[0])[None, :]
    return np.exp(logged[rows, cols].sum(axis=1) / available)
