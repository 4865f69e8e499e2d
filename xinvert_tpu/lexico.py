# -*- coding: utf-8 -*-
"""Lexicographic Gauss-Seidel executor: the reference's exact iterate
sequence, data-parallel.

The red-black engine (solver.py) reaches the same fixed point as the
reference but along a different transient, so fixed-ITERATION comparisons
against xinvert differ.  This executor reproduces the reference's
lexicographic in-place sweep (numbas.py:216-416) exactly — same values after
every iteration — by exploiting that the within-row update is a first-order
linear recurrence:

    S_new[i] = S_old[i] + r_i (g_i + sum_offrow w S_ctx
                               + w_xp[i] S_old[i+1] + w0_i S_old[i])
               + r_i w_xm[i] S_new[i-1]
             = A_i S_new[i-1] + B_i

which evaluates in O(log nx) with ``lax.associative_scan``; rows run
top-to-bottom under ``lax.scan`` (row j reads already-updated row j-1 from
the carry and old rows j+1 naturally).  Periodic-x follows the reference's
stanza order: west column first (old east value), interior recurrence, east
column last (new west/interior values).

Supports the radius-1-in-x 2-D families (standard, standard+E, general);
use it for fixed-iteration parity validation — the red-black engine remains
the throughput path.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .solver import _apply_extend

__all__ = ["solve_fixed_lexicographic", "solve_fixed_lexicographic_1d",
           "solve_fixed_lexicographic_3d", "solve_fixed_lexicographic_bih",
           "lexico_sweeper"]


def _w_at(spec, k, j):
    return spec.w[k][..., j, :]


def _scan_linear(A, B):
    """y_i = A_i y_{i-1} + B_i with y_{-1} = 0, via associative scan."""
    A, B = jnp.broadcast_arrays(A, B)

    def combine(l, r):
        al, bl = l
        ar, br = r
        return al * ar, bl * ar + br

    Acum, Bcum = jax.lax.associative_scan(combine, (A, B), axis=-1)
    return Bcum


def _one_iter_2d(spec, omega):
    """One reference-ordered 2-D sweep as a reusable ``S -> S`` callable
    (batched states supported).  2-D specs with |dx| <= 1 only."""
    if spec.ndim != 2:
        raise ValueError("lexicographic executor supports 2-D specs")
    if any(abs(off[1]) > 1 for off in spec.offsets):
        raise ValueError("within-row radius must be 1 (no biharmonic)")
    offs = {tuple(o): k for k, o in enumerate(spec.offsets)}
    kxp = offs.get((0, 1))
    kxm = offs.get((0, -1))
    periodic = spec.bcs[-1] == "periodic"
    ny = spec.w0.shape[-2]
    nx = spec.w0.shape[-1]
    omega = jnp.asarray(omega, spec.w0.dtype)

    # rows must be processed with static j for the j+dy indexing: use a
    # scan over traced j with dynamic_slice instead
    def offrow_acc_dyn(Scur, j):
        acc = jax.lax.dynamic_slice_in_dim(spec.g, j, 1, -2)[..., 0, :]
        for k, off in enumerate(spec.offsets):
            dy, dx = off
            if dy == 0:
                continue
            row = jax.lax.dynamic_slice_in_dim(Scur, j + dy, 1, -2)[..., 0, :]
            if dx:
                row = jnp.roll(row, -dx, axis=-1)
            wk = jax.lax.dynamic_slice_in_dim(spec.w[k], j, 1, -2)[..., 0, :]
            acc = acc + wk * row
        return acc

    def row_slice(a, j):
        return jax.lax.dynamic_slice_in_dim(a, j, 1, -2)[..., 0, :]

    def sweep_row_dyn(Scur, j):
        row_old = row_slice(Scur, j)
        ctx = offrow_acc_dyn(Scur, j)
        r = omega * row_slice(spec.relax, j)
        w0j = row_slice(spec.w0, j)
        wxp = row_slice(spec.w[kxp], j) if kxp is not None else 0.0
        wxm = row_slice(spec.w[kxm], j) if kxm is not None else 0.0

        if periodic:
            accw = ctx[..., 0] + (wxp[..., 0] * row_old[..., 1] if kxp is not None else 0.0) \
                + (wxm[..., 0] * row_old[..., nx - 1] if kxm is not None else 0.0)
            west = row_old[..., 0] + r[..., 0] * (accw + w0j[..., 0] * row_old[..., 0])
            row_w = row_old.at[..., 0].set(west)
        else:
            row_w = row_old

        Sop = jnp.roll(row_w, -1, axis=-1)
        base = row_w + r * (ctx + wxp * Sop + w0j * row_w)
        A = r * wxm if kxm is not None else jnp.zeros_like(row_w)
        Aseg = A[..., 1:nx - 1]
        Bseg = base[..., 1:nx - 1]
        Bseg = Bseg.at[..., 0].add(Aseg[..., 0] * row_w[..., 0])
        Aseg = Aseg.at[..., 0].set(0.0)
        interior = _scan_linear(Aseg, Bseg)
        row_new = row_w.at[..., 1:nx - 1].set(interior)

        if periodic:
            acce = ctx[..., nx - 1] \
                + (wxp[..., nx - 1] * row_new[..., 0] if kxp is not None else 0.0) \
                + (wxm[..., nx - 1] * row_new[..., nx - 2] if kxm is not None else 0.0)
            east = row_new[..., nx - 1] + r[..., nx - 1] * (
                acce + w0j[..., nx - 1] * row_new[..., nx - 1])
            row_new = row_new.at[..., nx - 1].set(east)

        nd = Scur.ndim
        return jax.lax.dynamic_update_slice_in_dim(
            Scur, row_new[..., None, :], j, nd - 2)

    def one_iter(Scur):
        Scur = _apply_extend(spec, Scur)

        def body(S, j):
            return sweep_row_dyn(S, j), None

        Scur, _ = jax.lax.scan(body, Scur, jnp.arange(1, ny - 1))
        return Scur

    return one_iter


@partial(jax.jit, static_argnames=("n_iters",))
def solve_fixed_lexicographic(spec, S, omega, n_iters: int):
    """Run n_iters reference-ordered sweeps (lexicographic in-place GS/SOR).

    Matches the reference kernels' per-iteration values (validated against
    the numpy oracle in tests/oracle.py).  2-D specs with |dx| <= 1 only.
    """
    one_iter = _one_iter_2d(spec, omega)
    return jax.lax.fori_loop(0, n_iters, lambda _, s: one_iter(s),
                             jnp.asarray(S))


def _one_iter_1d(spec, omega):
    """One reference-ordered 1-D sweep (invert_standard_1D,
    /root/reference/xinvert/numbas.py:633) as an ``S -> S`` callable:
    extend pre-pass, then the periodic west stanza (old east value), the
    in-place interior recurrence (i = 1..nx-2), and the periodic east
    stanza (new values).  Unbatched 1-D states."""
    if spec.ndim != 1:
        raise ValueError("1-D specs only")
    offs = {tuple(o): k for k, o in enumerate(spec.offsets)}
    kxp, kxm = offs.get((1,)), offs.get((-1,))
    periodic = spec.bcs[-1] == "periodic"
    nx = spec.w0.shape[-1]
    omega = jnp.asarray(omega, spec.w0.dtype)

    def one_iter(row_old):
        row_old = _apply_extend(spec, row_old)
        r = omega * spec.relax
        w0 = spec.w0
        wxp = spec.w[kxp] if kxp is not None else 0.0
        wxm = spec.w[kxm] if kxm is not None else 0.0
        if periodic:
            accw = spec.g[0] + wxp[0] * row_old[1] + wxm[0] * row_old[nx - 1]
            row_w = row_old.at[0].add(r[0] * (accw + w0[0] * row_old[0]))
        else:
            row_w = row_old
        base = row_w + r * (spec.g + wxp * jnp.roll(row_w, -1)
                            + w0 * row_w)
        A = r * wxm if kxm is not None else jnp.zeros_like(row_w)
        Aseg = A[1:nx - 1]
        Bseg = base[1:nx - 1]
        Bseg = Bseg.at[0].add(Aseg[0] * row_w[0])
        Aseg = Aseg.at[0].set(0.0)
        row_new = row_w.at[1:nx - 1].set(_scan_linear(Aseg, Bseg))
        if periodic:
            acce = spec.g[nx - 1] + wxp[nx - 1] * row_new[0] \
                + wxm[nx - 1] * row_new[nx - 2]
            row_new = row_new.at[nx - 1].add(
                r[nx - 1] * (acce + w0[nx - 1] * row_new[nx - 1]))
        return row_new

    return one_iter


@partial(jax.jit, static_argnames=("n_iters",))
def solve_fixed_lexicographic_1d(spec, S, omega, n_iters: int):
    """Run n_iters reference-ordered 1-D sweeps (a parity tool)."""
    if jnp.ndim(S) != 1:
        raise ValueError("unbatched 1-D state required")
    one_iter = _one_iter_1d(spec, omega)
    return jax.lax.fori_loop(0, n_iters, lambda _, s: one_iter(s),
                             jnp.asarray(S))


def _scan_affine2(A1, A2, B, y1, y0):
    """Second-order linear recurrence y_i = A1_i y_{i-1} + A2_i y_{i-2} + B_i
    (i = 0..n-1 of the supplied arrays) with seeds (y1, y0) = (y_{-1}, y_{-2}),
    via an associative scan of affine 2x2 maps on the state (y_i, y_{i-1})."""
    m11, m12 = A1, A2
    m21 = jnp.ones_like(A1)
    m22 = jnp.zeros_like(A1)
    v1, v2 = B, jnp.zeros_like(B)
    # fold the seed into element 0: s_0 = M_0 (y1, y0) + b_0, M_0 <- 0
    v1 = v1.at[..., 0].add(A1[..., 0] * y1 + A2[..., 0] * y0)
    v2 = v2.at[..., 0].add(y1)
    m11 = m11.at[..., 0].set(0.0)
    m12 = m12.at[..., 0].set(0.0)
    m21 = m21.at[..., 0].set(0.0)

    def combine(l, r):
        l11, l12, l21, l22, lv1, lv2 = l
        r11, r12, r21, r22, rv1, rv2 = r
        return (r11 * l11 + r12 * l21, r11 * l12 + r12 * l22,
                r21 * l11 + r22 * l21, r21 * l12 + r22 * l22,
                r11 * lv1 + r12 * lv2 + rv1,
                r21 * lv1 + r22 * lv2 + rv2)

    out = jax.lax.associative_scan(combine, (m11, m12, m21, m22, v1, v2),
                                   axis=-1)
    return out[4]


def _one_iter_bih(spec, omega):
    """One reference-ordered biharmonic sweep
    (invert_general_bih_2D, /root/reference/xinvert/numbas.py:1205).

    Stanza order replicated exactly: extend pre-pass, then per row
    (j = 2..ny-3) west columns 0 and 1, the interior in-place update
    (i = 2..nx-3), east columns nx-2 and nx-1 (periodic x only).  The
    within-row update reads the already-updated i-1 AND i-2 — a
    second-order linear recurrence, evaluated in O(log nx) with an affine
    2x2 associative scan.

    East periodic stanzas implement the INTENDED symmetric discretization;
    the reference's own east stanzas read a stale loop index for the
    B-cross term (``S[j+-2, i-4]`` with i left at xc-3, numbas.py:1495-1497
    and :1526-1528), so exact per-iteration parity with the reference holds
    when B vanishes on the east columns (tests/test_reference_direct.py
    demonstrates the stale-index deviation is real).  Unbatched 2-D states
    only (``lexico_sweeper`` lifts batches with vmap)."""
    if spec.ndim != 2 or not spec.bih:
        raise ValueError("bih executor: 2-D biharmonic specs only")
    offs = {tuple(o): k for k, o in enumerate(spec.offsets)}
    periodic = spec.bcs[-1] == "periodic"
    ny, nx = spec.w0.shape[-2:]
    omega = jnp.asarray(omega, spec.w0.dtype)

    def row_slice(a, j):
        return jax.lax.dynamic_slice_in_dim(a, j, 1, a.ndim - 2)[..., 0, :]

    def sweep_row(Scur, j):
        row_old = row_slice(Scur, j)
        ctx = row_slice(spec.g, j)
        for k, off in enumerate(spec.offsets):
            dy, dx = off
            if dy == 0:
                continue
            rr = row_slice(Scur, j + dy)
            if dx:
                rr = jnp.roll(rr, -dx, -1)
            ctx = ctx + row_slice(spec.w[k], j) * rr
        r = omega * row_slice(spec.relax, j)
        w0j = row_slice(spec.w0, j)
        wx = {dx: (row_slice(spec.w[offs[(0, dx)]], j)
                   if (0, dx) in offs else jnp.zeros_like(row_old))
              for dx in (-2, -1, 1, 2)}

        def gs_at(rowv, i):
            # one in-place GS update at STATIC column i (wrap via % nx)
            acc = ctx[i] + w0j[i] * rowv[i]
            for dx in (-2, -1, 1, 2):
                acc = acc + wx[dx][i] * rowv[(i + dx) % nx]
            return rowv.at[i].add(r[i] * acc)

        rowv = row_old
        if periodic:
            rowv = gs_at(rowv, 0)
            rowv = gs_at(rowv, 1)
        # interior i in [2, nx-2): y_i = A1 y_{i-1} + A2 y_{i-2} + B_i with
        # B_i folding the old east-side neighbors (i+1, i+2 not yet updated)
        base = rowv + r * (ctx + wx[1] * jnp.roll(rowv, -1, -1)
                           + wx[2] * jnp.roll(rowv, -2, -1) + w0j * rowv)
        sl = slice(2, nx - 2)
        interior = _scan_affine2((r * wx[-1])[sl], (r * wx[-2])[sl],
                                 base[sl], rowv[1], rowv[0])
        rowv = rowv.at[sl].set(interior)
        if periodic:
            rowv = gs_at(rowv, nx - 2)
            rowv = gs_at(rowv, nx - 1)
        return jax.lax.dynamic_update_slice_in_dim(
            Scur, rowv[None, :], j, Scur.ndim - 2)

    def one_iter(Scur):
        Scur = _apply_extend(spec, Scur)

        def body(Sc, j):
            return sweep_row(Sc, j), None

        Scur, _ = jax.lax.scan(body, Scur, jnp.arange(2, ny - 2))
        return Scur

    return one_iter


@partial(jax.jit, static_argnames=("n_iters",))
def solve_fixed_lexicographic_bih(spec, S, omega, n_iters: int):
    """Run n_iters reference-ordered biharmonic sweeps (a parity tool —
    the red-black engine is the throughput path)."""
    if jnp.ndim(S) != 2:
        raise ValueError("unbatched 2-D state required")
    one_iter = _one_iter_bih(spec, omega)
    return jax.lax.fori_loop(0, n_iters, lambda _, s: one_iter(s),
                             jnp.asarray(S))


def _one_iter_3d(spec, omega):
    """One 3-D reference-ordered sweep (numbas.py:16-212 ordering: k outer,
    j middle, i inner).  Rows are (k, j) pairs scanned in lexicographic
    order; the within-row update uses the same associative-scan recurrence
    as the 2-D executor.  Unbatched 3-D states only."""
    if spec.ndim != 3:
        raise ValueError("use solve_fixed_lexicographic for 2-D specs")
    if any(abs(off[2]) > 1 for off in spec.offsets):
        raise ValueError("within-row radius must be 1")
    offs = {tuple(o): k for k, o in enumerate(spec.offsets)}
    kxp = offs.get((0, 0, 1))
    kxm = offs.get((0, 0, -1))
    periodic = spec.bcs[-1] == "periodic"
    nz, ny, nx = spec.w0.shape[-3:]
    omega = jnp.asarray(omega, spec.w0.dtype)

    def row(a, k, j):
        a1 = jax.lax.dynamic_slice_in_dim(a, k, 1, a.ndim - 3)
        a2 = jax.lax.dynamic_slice_in_dim(a1, j, 1, a.ndim - 2)
        return a2[..., 0, 0, :]

    def ctx(Scur, k, j):
        acc = row(spec.g, k, j)
        for m, off in enumerate(spec.offsets):
            dz, dy, dx = off
            if dz == 0 and dy == 0:
                continue
            r = row(Scur, k + dz, j + dy)
            if dx:
                r = jnp.roll(r, -dx, -1)
            acc = acc + row(spec.w[m], k, j) * r
        return acc

    def sweep_row(Scur, kj):
        k = 1 + kj // (ny - 2)
        j = 1 + kj % (ny - 2)
        row_old = row(Scur, k, j)
        c = ctx(Scur, k, j)
        r = omega * row(spec.relax, k, j)
        w0r = row(spec.w0, k, j)
        wxp = row(spec.w[kxp], k, j) if kxp is not None else 0.0
        wxm = row(spec.w[kxm], k, j) if kxm is not None else 0.0

        if periodic:
            accw = c[0] + (wxp[0] * row_old[1] if kxp is not None else 0.0) \
                + (wxm[0] * row_old[nx - 1] if kxm is not None else 0.0)
            west = row_old[0] + r[0] * (accw + w0r[0] * row_old[0])
            row_w = row_old.at[0].set(west)
        else:
            row_w = row_old

        Sop = jnp.roll(row_w, -1, -1)
        base = row_w + r * (c + wxp * Sop + w0r * row_w)
        A = r * wxm if kxm is not None else jnp.zeros_like(row_w)
        Aseg = A[1:nx - 1]
        Bseg = base[1:nx - 1]
        Bseg = Bseg.at[0].add(Aseg[0] * row_w[0])
        Aseg = Aseg.at[0].set(0.0)
        interior = _scan_linear(Aseg, Bseg)
        row_new = row_w.at[1:nx - 1].set(interior)

        if periodic:
            acce = c[nx - 1] \
                + (wxp[nx - 1] * row_new[0] if kxp is not None else 0.0) \
                + (wxm[nx - 1] * row_new[nx - 2] if kxm is not None else 0.0)
            east = row_new[nx - 1] + r[nx - 1] * (
                acce + w0r[nx - 1] * row_new[nx - 1])
            row_new = row_new.at[nx - 1].set(east)

        return jax.lax.dynamic_update_slice(
            Scur, row_new[None, None, :], (k, j, 0))

    def one_iter(Scur):
        Scur = _apply_extend(spec, Scur)

        def body(Sc, kj):
            return sweep_row(Sc, kj), None

        Scur, _ = jax.lax.scan(body, Scur,
                               jnp.arange((nz - 2) * (ny - 2)))
        return Scur

    return one_iter


@partial(jax.jit, static_argnames=("n_iters",))
def solve_fixed_lexicographic_3d(spec, S, omega, n_iters: int):
    """Run n_iters 3-D reference-ordered sweeps (a parity tool)."""
    if jnp.ndim(S) != 3:
        raise ValueError("unbatched 3-D state required")
    one_iter = _one_iter_3d(spec, omega)
    return jax.lax.fori_loop(0, n_iters, lambda _, s: one_iter(s),
                             jnp.asarray(S))


def lexico_sweeper(spec, omega, S_shape):
    """Dispatch one reference-ordered sweep for any family as an
    ``S -> S`` callable (the ``scheme='lexico'`` engine behind
    :func:`xinvert_tpu.solver.solve`).

    The 2-D radius-1 executor is natively batched.  The 1-D, biharmonic
    and 3-D executors are written unbatched and lifted over leading batch
    axes with ``jax.vmap`` — JOINTLY over state and spec: the app-layer
    builders bake batched forcing (and possibly batched coefficients)
    into the spec's data leaves, so each leaf is first broadcast to the
    full batch prefix and then mapped alongside the state (StencilSpec is
    a registered dataclass pytree; ``w`` keeps its leading K axis)."""
    nbatch = len(S_shape) - spec.ndim
    if nbatch < 0:
        raise ValueError(f"state rank {len(S_shape)} below spec.ndim")
    if spec.ndim == 2 and not spec.bih \
            and all(abs(off[1]) <= 1 for off in spec.offsets):
        return _one_iter_2d(spec, omega)
    if spec.ndim == 1:
        builder = _one_iter_1d
    elif spec.ndim == 2 and spec.bih:
        builder = _one_iter_bih
    elif spec.ndim == 3:
        builder = _one_iter_3d
    else:
        raise ValueError(
            f"no lexicographic executor for ndim={spec.ndim} offsets="
            f"{spec.offsets}")
    if nbatch == 0:
        return builder(spec, omega)

    import dataclasses
    batch_shape = tuple(S_shape[:nbatch])
    core = spec.ndim

    def lift(a, lead):
        # insert any missing batch axes after the `lead` structural axes
        # (w's K axis), then broadcast size-1 batch dims to the full prefix
        a = jnp.asarray(a)
        have = a.ndim - lead - core
        if have > nbatch:
            raise ValueError(
                f"spec leaf has {have} batch axes, state has {nbatch}")
        for _ in range(nbatch - have):
            a = jnp.expand_dims(a, lead)
        want = a.shape[:lead] + batch_shape + a.shape[a.ndim - core:]
        return jnp.broadcast_to(a, want)

    spec_b = dataclasses.replace(
        spec, w=lift(spec.w, 1), w0=lift(spec.w0, 0), g=lift(spec.g, 0),
        relax=lift(spec.relax, 0), active=lift(spec.active, 0))
    axes = dataclasses.replace(spec_b, w=1, w0=0, g=0, relax=0, active=0)

    def fn(sp, S):
        return builder(sp, omega)(S)

    for _ in range(nbatch):
        fn = jax.vmap(fn, in_axes=(axes, 0))
    return partial(fn, spec_b)
