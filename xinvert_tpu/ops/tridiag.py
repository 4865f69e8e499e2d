# -*- coding: utf-8 -*-
"""Tridiagonal (Thomas) solvers, plain and cyclic.

JAX equivalents of the reference's exported ``trace``/``traceCyclic``
(/root/reference/xinvert/numbas.py:1590-1685): the Thomas elimination is a
linear recurrence expressed with ``lax.scan`` so it jits/vmaps cleanly; the
cyclic variant removes the periodic corner entries with the standard
Sherman-Morrison bordering used by the reference.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["trace", "traceCyclic", "tridiag_solve",
           "tridiag_solve_pscan", "tridiag_cyclic_pscan"]


@jax.jit
def tridiag_solve(a, b, c, d):
    """Solve tridiagonal systems along the last axis: a sub-diagonal (N-1),
    b diagonal (N), c super-diagonal (N-1), d rhs (N), with leading batch
    axes broadcast.  Sequential Thomas elimination: two length-N
    ``lax.scan``s, the accurate choice for the weakly dominant systems of
    elliptic operators."""
    a, b, c, d = (jnp.asarray(x) for x in (a, b, c, d))
    dtype = jnp.result_type(a, b, c, d)
    zero = jnp.zeros(a.shape[:-1] + (1,), dtype)
    a_full = jnp.concatenate([zero, a.astype(dtype)], -1)  # couples i, i-1
    c_full = jnp.concatenate([c.astype(dtype), zero], -1)
    a_full, b, c_full, d = (jnp.moveaxis(x, -1, 0) for x in jnp.broadcast_arrays(
        a_full, b.astype(dtype), c_full, d.astype(dtype)))

    # forward elimination: cp[i] = c[i]/(b[i]-a[i]*cp[i-1]),
    #                      dp[i] = (d[i]-a[i]*dp[i-1])/(b[i]-a[i]*cp[i-1])
    def fwd(carry, x):
        cp_prev, dp_prev = carry
        ai, bi, ci, di = x
        denom = bi - ai * cp_prev
        cp = ci / denom
        dp = (di - ai * dp_prev) / denom
        return (cp, dp), (cp, dp)

    init = jnp.zeros_like(b[0])
    _, (cp, dp) = jax.lax.scan(fwd, (init, init), (a_full, b, c_full, d))

    # back substitution: x[i] = dp[i] - cp[i]*x[i+1]
    def bwd(x_next, t):
        cpi, dpi = t
        x = dpi - cpi * x_next
        return x, x

    _, xs = jax.lax.scan(bwd, init, (cp, dp), reverse=True)
    return jnp.moveaxis(xs, 0, -1)


def _affine_scan(A, B, reverse=False):
    """Prefix (or suffix) evaluation of y_i = A_i y_prev + B_i along the
    last axis with y_prev(start) = 0, via an associative scan."""
    A, B = jnp.broadcast_arrays(A, B)

    def comb(l, r):
        # r is applied AFTER l in scan order (suffix order when reversed)
        al, bl = l
        ar, br = r
        return al * ar, bl * ar + br

    if reverse:
        _, Bc = jax.lax.associative_scan(comb, (A[..., ::-1], B[..., ::-1]),
                                         axis=-1)
        return Bc[..., ::-1]
    _, Bc = jax.lax.associative_scan(comb, (A, B), axis=-1)
    return Bc


@jax.jit
def tridiag_solve_pscan(a, b, c, d):
    """Batched LOG-DEPTH Thomas solve along the last axis.

    Same system convention as :func:`tridiag_solve` (a: N-1 subdiagonal,
    b: N diagonal, c: N-1 superdiagonal, d: N rhs), with arbitrary
    leading batch axes.  The sequential solver runs two length-N
    ``lax.scan``s, one step at a time; here the
    forward elimination's rational recurrence
    ``cp_i = c_i / (b_i - a_i cp_{i-1})`` runs as an associative scan of
    projectively-normalised 2x2 Moebius maps, and the dp/back-substitution
    recurrences (affine once cp is known) as associative scans — O(log N)
    depth, fully vectorised over lines.  Stable for the diagonally
    dominant systems the smoothers build (the per-combine normalisation
    keeps the Moebius products bounded); results match the sequential
    solver to roundoff (tests/test_trace.py)."""
    a, b, c, d = (jnp.asarray(x) for x in (a, b, c, d))
    dtype = jnp.result_type(a, b, c, d)
    a, b, c, d = (x.astype(dtype) for x in (a, b, c, d))
    n = b.shape[-1]
    # the (expensive, normalised) Moebius elimination depends only on the
    # BANDS: compute it at the band batch shape and broadcast just the
    # (cheap) affine dp/back-substitution scans over any extra rhs batch
    # axes (e.g. the capacitance path's stacked unit responses)
    band_batch = jnp.broadcast_shapes(a.shape[:-1], b.shape[:-1],
                                      c.shape[:-1])
    batch = jnp.broadcast_shapes(band_batch, d.shape[:-1])
    bb = jnp.broadcast_to(b, band_batch + (n,))
    zb = jnp.zeros(band_batch + (1,), dtype)
    a_full = jnp.concatenate(
        [zb, jnp.broadcast_to(a, band_batch + (n - 1,))], axis=-1)
    c_full = jnp.concatenate(
        [jnp.broadcast_to(c, band_batch + (n - 1,)), zb], axis=-1)
    d = jnp.broadcast_to(d, batch + (n,))

    # cp_i as a Moebius chain: cp_i = (0*cp + c_i) / (-a_i*cp + b_i)
    m11 = jnp.zeros_like(bb)
    m12 = c_full
    m21 = -a_full
    m22 = bb

    def comb(l, r):
        l11, l12, l21, l22 = l
        r11, r12, r21, r22 = r
        p11 = r11 * l11 + r12 * l21
        p12 = r11 * l12 + r12 * l22
        p21 = r21 * l11 + r22 * l21
        p22 = r21 * l12 + r22 * l22
        # projective normalisation: scale-invariant Moebius representative
        s = jnp.maximum(jnp.maximum(jnp.abs(p11), jnp.abs(p12)),
                        jnp.maximum(jnp.abs(p21), jnp.abs(p22)))
        s = jnp.where(s > 0, s, 1.0)
        return p11 / s, p12 / s, p21 / s, p22 / s

    P11, P12, P21, P22 = jax.lax.associative_scan(
        comb, (m11, m12, m21, m22), axis=-1)
    cp = P12 / P22                        # applied to cp_0 = 0

    cp_prev = jnp.concatenate([zb, cp[..., :-1]], axis=-1)
    denom = bb - a_full * cp_prev
    dp = _affine_scan(jnp.broadcast_to(-a_full / denom, batch + (n,)),
                      d / denom)

    # x_i = dp_i - cp_i x_{i+1}, x_N = 0  (suffix recurrence)
    return _affine_scan(jnp.broadcast_to(-cp, batch + (n,)), dp,
                        reverse=True)


@jax.jit
def tridiag_cyclic_pscan(a, b, c, d, a0, cn):
    """Batched log-depth cyclic tridiagonal solve along the last axis
    (corner couplings ``a0``: row 0 -> col N-1, ``cn``: row N-1 -> col 0;
    leading axes batch, a0/cn shaped like the batch).  Sherman-Morrison
    bordering over :func:`tridiag_solve_pscan`, with the three rhs solved
    in ONE stacked call."""
    b = jnp.asarray(b)
    dtype = b.dtype
    batch = b.shape[:-1]
    n = b.shape[-1]
    a0 = jnp.broadcast_to(jnp.asarray(a0, dtype), batch)
    cn = jnp.broadcast_to(jnp.asarray(cn, dtype), batch)
    e1 = jnp.zeros(batch + (n,), dtype).at[..., 0].set(a0)
    en = jnp.zeros(batch + (n,), dtype).at[..., n - 1].set(cn)
    rhs = jnp.stack([jnp.broadcast_to(jnp.asarray(d, dtype),
                                      batch + (n,)), e1, en])
    # bands stay at the line batch; only the affine scans see the
    # 3-way rhs stack (the Moebius elimination is computed once)
    sol = tridiag_solve_pscan(a, b, c, rhs)
    x0, u1, u2 = sol[0], sol[1], sol[2]
    det = ((1.0 + u2[..., 0]) * (1.0 + u1[..., n - 1])
           - u1[..., 0] * u2[..., n - 1])
    x0c = ((1.0 + u1[..., n - 1]) * x0[..., 0]
           - u1[..., 0] * x0[..., n - 1]) / det
    xN1 = ((1.0 + u2[..., 0]) * x0[..., n - 1]
           - u2[..., n - 1] * x0[..., 0]) / det
    return x0 - u1 * xN1[..., None] - u2 * x0c[..., None]


def trace(a, b, c, d):
    """Reference-compatible Thomas solve (numbas.py:1590-1636)."""
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    c = jnp.asarray(c)
    d = jnp.asarray(d)
    n = b.shape[0]
    if a.shape[0] != n - 1 or c.shape[0] != n - 1 or d.shape[0] != n:
        raise ValueError("lengths of given arrays are not satisfied")
    return tridiag_solve(a, b, c, d)


def traceCyclic(a, b, c, d, a0, cn):
    """Cyclic tridiagonal solve with corner couplings a0 (row 0 -> col N-1)
    and cn (row N-1 -> col 0), via bordering (numbas.py:1640-1685)."""
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    c = jnp.asarray(c)
    d = jnp.asarray(d)
    n = b.shape[0]
    dtype = b.dtype
    e1 = jnp.zeros((n,), dtype).at[0].set(1.0)
    en = jnp.zeros((n,), dtype).at[n - 1].set(1.0)
    # columns of the correction: A x = d with A = T + a0*e1 en^T + cn*en e1^T
    u1 = tridiag_solve(a, b, c, e1 * a0)   # T^-1 (a0 e1)
    u2 = tridiag_solve(a, b, c, en * cn)   # T^-1 (cn en)
    x0 = tridiag_solve(a, b, c, d)
    # Bordering: A = T + a0*e1*en^T + cn*en*e1^T, so
    #   x = x0 - u1 * x_{n-1} - u2 * x_0
    # (u1 multiplies x_{n-1}: a0 couples row 0 to column n-1;
    #  u2 multiplies x_0:     cn couples row n-1 to column 0).
    # Evaluating that identity at rows 0 and n-1 gives the 2x2 system
    #   (1 + u2[0]) x_0   + u1[0] x_{n-1}       = x0[0]
    #   u2[n-1] x_0       + (1 + u1[n-1]) x_{n-1} = x0[n-1]
    det = (1.0 + u2[0]) * (1.0 + u1[n - 1]) - u1[0] * u2[n - 1]
    x0c = ((1.0 + u1[n - 1]) * x0[0] - u1[0] * x0[n - 1]) / det
    xN1 = ((1.0 + u2[0]) * x0[n - 1] - u2[n - 1] * x0[0]) / det
    return x0 - u1 * xN1 - u2 * x0c
