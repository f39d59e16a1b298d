# -*- coding: utf-8 -*-
"""
STA/LTA onset (characteristic) functions as jitted JAX programs.

Semantics mirror the reference C kernels exactly (onsetlib.c:35-148):

- "overlapping" (classic): STA window is the trailing ``nsta`` samples of
  the LTA window; value assigned at the shared end sample. Samples before
  index nlta-1 are 1 (null result).
- "centred": STA window immediately *follows* the LTA window; value
  assigned at the end of the LTA window. Trailing nsta samples are 1.
- "recursive": exponential-decay recursion; first nlta samples nulled to 1.

All variants are expressed with cumulative sums (the recursion via an
associative scan), so they vectorise on any backend and batch over
channels. Division-by-zero yields the null result 1, following the
reference's Python backends (stalta.py:25-134).

"""

from functools import partial

import jax
import jax.numpy as jnp

from . import rolling


def _windowed_sums(signal, nsta, nlta):
    """Trailing-window rolling sums: sta[i] = sum(signal[i-nsta+1..i])."""

    return (
        rolling.trailing_window_sums(signal, nsta),
        rolling.trailing_window_sums(signal, nlta),
    )


@partial(jax.jit, static_argnames=("nsta", "nlta"))
def overlapping_sta_lta(signal, nsta, nlta):
    """
    Classic STA/LTA with overlapping windows, batched over leading dims.
    Returns ones for the first nlta-1 samples.

    """

    signal = jnp.asarray(signal)
    n = signal.shape[-1]
    sta, lta = _windowed_sums(signal, nsta, nlta)
    frac = nlta / nsta
    tiny = jnp.finfo(signal.dtype).tiny
    ratio = jnp.where(lta < tiny, 1.0, sta / jnp.maximum(lta, tiny) * frac)
    valid = jnp.arange(n) >= (nlta - 1)
    return jnp.where(valid, ratio, 1.0)


@partial(jax.jit, static_argnames=("nsta", "nlta"))
def centred_sta_lta(signal, nsta, nlta):
    """
    Centred STA/LTA: the STA window follows the LTA window; the value is
    assigned to the last sample of the LTA window. Both the first nlta-1
    and the last nsta samples are 1.

    """

    signal = jnp.asarray(signal)
    n = signal.shape[-1]
    csum = jnp.cumsum(signal, axis=-1)
    padded = jnp.concatenate(
        [jnp.zeros(signal.shape[:-1] + (1,), csum.dtype), csum], axis=-1
    )
    idx = jnp.arange(n)
    # lta[i] = sum(signal[i-nlta+1..i]); sta[i] = sum(signal[i+1..i+nsta])
    lta = padded[..., idx + 1] - padded[..., jnp.maximum(idx + 1 - nlta, 0)]
    hi = jnp.minimum(idx + 1 + nsta, n)
    sta = padded[..., hi] - padded[..., idx + 1]
    frac = nlta / nsta
    tiny = jnp.finfo(signal.dtype).tiny
    ratio = jnp.where(lta <= 0.0, 1.0, sta / jnp.maximum(lta, tiny) * frac)
    valid = (idx >= (nlta - 1)) & (idx < n - nsta)
    return jnp.where(valid, ratio, 1.0)


@partial(jax.jit, static_argnames=("nsta", "nlta"))
def recursive_sta_lta(signal, nsta, nlta):
    """
    Recursive STA/LTA: sta_i = c*x_i + (1-c)*sta_{i-1} with c = 1/nsta
    (similarly for lta), computed with an associative scan so it
    parallelises despite the recurrence. Matching the reference
    (core/src/onsetlib.c:126-148 + the zero-initialised output buffer in
    core/lib.py:252-285): when nlta < n the first nlta samples — sample 0
    included — are nulled to 1; when nlta >= n nothing is nulled and
    sample 0 stays 0.

    """

    signal = jnp.asarray(signal)
    n = signal.shape[-1]

    def ewma(x, c):
        # s_i = c*x_i + (1-c)*s_{i-1}, s_{-1} = 0, skipping i=0 (loop starts
        # at 1 in the reference) -> zero the first input.
        x0 = x.at[..., 0].set(0.0)
        decay = jnp.full(n, 1.0 - c, dtype=x.dtype)
        decay = decay.at[0].set(0.0)

        def combine(a, b):
            # pairs (m, v): s_i = m_i * s_{i-1} + v_i
            m1, v1 = a
            m2, v2 = b
            return m1 * m2, v1 * m2 + v2

        _, s = jax.lax.associative_scan(
            combine, (jnp.broadcast_to(decay, x.shape), c * x0), axis=-1
        )
        return s

    sta = ewma(signal, 1.0 / nsta)
    lta = ewma(signal, 1.0 / nlta)
    tiny = jnp.finfo(signal.dtype).tiny
    onset = sta / jnp.maximum(lta, tiny)
    onset = onset.at[..., 0].set(0.0)
    if nlta < n:
        onset = jnp.where(jnp.arange(n) < nlta, 1.0, onset)
    return onset


@partial(jax.jit, static_argnames=("transform",))
def signal_transform(data, transform="energy"):
    """
    Non-negative signal transform applied before the STA/LTA: "energy"
    (x**2), "abs", "env" (analytic-signal envelope) or "env_squared".
    (reference: stalta.py:516-523)

    """

    data = jnp.asarray(data)
    if transform == "energy":
        return data**2
    if transform == "abs":
        return jnp.abs(data)
    if transform in ("env", "env_squared"):
        env = _envelope(data)
        return env**2 if transform == "env_squared" else env
    raise ValueError(f"Unknown signal transform: {transform}")


def _envelope(data):
    """|analytic signal| via an FFT Hilbert transform along the last axis."""

    n = data.shape[-1]
    spec = jnp.fft.fft(data, axis=-1)
    h = jnp.zeros(n, dtype=spec.dtype)
    if n % 2 == 0:
        h = h.at[0].set(1).at[n // 2].set(1).at[1 : n // 2].set(2)
    else:
        h = h.at[0].set(1).at[1 : (n + 1) // 2].set(2)
    analytic = jnp.fft.ifft(spec * h, axis=-1)
    return jnp.abs(analytic)
