# -*- coding: utf-8 -*-
"""Error-free transformations (EFT) and the compensated stencil residual.

A float32 solve (the fast path on an accelerator, unlike the reference's
f64 numba kernels) has a relative-residual floor: that of the
plain residual evaluation — roughly ``eps * mean|w0*S| / mean|g|`` (see
``solve``'s docstring) — reaches ~1e-1 on the 2048^2 full-sphere Poisson
(polar metric inflation).  This module removes the MEASUREMENT part of
that floor: the per-cell residual ``sum_k w_k S_k + w0 S + g`` is evaluated
with Dekker/Knuth error-free transformations (TwoProd via Veltkamp
splitting + TwoSum cascades, Ogita-Rump-Oishi "Sum2"), making each cell's
residual accurate to O(eps^2 * condition) — f64-class accuracy from pure
f32 ops, ~10x the flops of the plain pass but only run once per
convergence check.

Combined with a DOUBLE-FLOAT32 state (an unevaluated (hi, lo) pair carried
by :mod:`xinvert_tpu.refine`'s iterative refinement), this lifts the
STATE-precision part of the floor as well: the certified relative residual
then reaches ~1e-7 on problems where plain f32 stalls at 1e-3..1e-1.

EFT identities hold in IEEE round-to-nearest arithmetic, which XLA's
default (non-fast-math, no reassociation, no contraction into FMA) float
semantics preserve (validated against f64 in tests/test_refine.py on the
CPU and in tests/test_chip.py on an NVIDIA GPU).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["two_sum", "two_prod", "residual_compensated",
           "residual_norm_compensated"]


def two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly, s = fl(a + b)."""
    s = a + b
    t = s - a
    e = (a - (s - t)) + (b - t)
    return s, e


def _split_factor(dtype):
    # Veltkamp splitting factor 2^ceil(p/2) + 1 (p = significand bits)
    p = np.finfo(dtype).nmant + 1
    return dtype.type(2.0 ** ((p + 1) // 2) + 1.0)


def two_prod(a, b):
    """Dekker TwoProd (no FMA): p + e == a * b exactly, p = fl(a * b).

    Veltkamp splitting overflows for |a| > max/(2^12+1) (~8e34 in f32) —
    far beyond any stencil weight this package builds.
    """
    p = a * b
    f = _split_factor(jnp.result_type(a))
    ca = f * a
    ahi = ca - (ca - a)
    alo = a - ahi
    cb = f * b
    bhi = cb - (cb - b)
    blo = b - bhi
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


def _shift(S, off, nd):
    shifts = tuple(-o for o in off if o != 0)
    axes = tuple(ax - nd for ax, o in enumerate(off) if o != 0)
    return jnp.roll(S, shift=shifts, axis=axes) if shifts else S


@jax.jit
def residual_compensated(spec, S, S_lo=None):
    """Per-cell residual ``sum_k w_k S[.+off_k] + w0 S + g`` with compensated
    (Sum2/TwoProd) accumulation of the ``S`` contributions.

    ``S_lo`` (optional) is the low word of a double-float32 state: its
    contribution ``sum_k w_k S_lo[.+off_k] + w0 S_lo`` is O(eps) of the
    leading terms, so plain f32 evaluation of it keeps the total at
    O(eps^2) accuracy.  Unmasked (raw) residual — callers apply
    ``spec.active`` where needed.

    Jitted at the definition: the ~100-op EFT cascade otherwise runs
    EAGERLY, one dispatch per op, from the host refinement loop.
    (EFT identities survive compilation: XLA does not reassociate floats.)
    """
    nd = spec.ndim
    s = jnp.asarray(spec.g, S.dtype)
    e = jnp.zeros((), S.dtype)
    for k, off in enumerate(spec.offsets):
        p, pe = two_prod(spec.w[k], _shift(S, off, nd))
        s, se = two_sum(s, p)
        e = e + (se + pe)
    p, pe = two_prod(spec.w0, S)
    s, se = two_sum(s, p)
    e = e + (se + pe)
    if S_lo is not None:
        c = spec.w0 * S_lo
        for k, off in enumerate(spec.offsets):
            c = c + spec.w[k] * _shift(S_lo, off, nd)
        e = e + c
    return s + e


@jax.jit
def residual_norm_compensated(spec, S, S_lo=None):
    """Compensated mean |residual| over active cells, per batch slice.

    The per-cell residuals carry O(eps^2)-accurate values; |r| terms are
    non-negative, so the f32 tree reduction's relative error is
    O(eps log N) of the mean itself — the certified norm is accurate to
    ~1e-6 of its own value.
    """
    axes = tuple(range(-spec.ndim, 0))
    r = jnp.where(spec.active, residual_compensated(spec, S, S_lo), 0.0)
    n_active = jnp.maximum(jnp.sum(spec.active), 1)
    return jnp.sum(jnp.abs(r), axis=axes) / n_active
