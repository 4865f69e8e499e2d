# -*- coding: utf-8 -*-
"""Direct spectral solve for x-invariant 2-D stencil problems.

A capability the reference lacks (its FFT experiments were
abandoned in comments, /root/reference/tests/test_LLC4320Poisson.py:108-217):
for a 2-D, non-biharmonic :class:`~xinvert_tpu.stencil.StencilSpec` whose
weight planes do not vary along x, with periodic x and an unmasked interior,
the real FFT along x block-diagonalises the folded system

    sum_k w_k S[. + off_k] + w0 S = -g

into one complex tridiagonal system in y per zonal wavenumber — solvable
exactly in a single pass (Thomas elimination, vectorised over every
mode).  This covers the reference's
canonical global problems — Poisson/Helmholtz streamfunction,
Gill-Matsuno (±test form), geostrophic balance — at machine precision in
one shot instead of hundreds-to-thousands of SOR sweeps: one batched
FFT + one vectorised line solve, no iteration.

NON-periodic x (fixed or extend) is covered too when the x-coupling is
left-right symmetric per row and there are no cross/advective x terms
(true of the whole standard-2D family): the x-operator is then
``c(y)·T0`` with ``T0`` the unit Dirichlet tridiagonal, so one host-side
eigendecomposition of ``T0`` (computed once per spec at trace time)
block-diagonalises the system into ``nxi`` REAL tridiagonal solves in y,
and the transform pair is a plain matmul.  Note the
reference's 'extend' is a ROW pre-pass only (numbas.py:284-310): a
non-periodic trailing dim keeps its initial boundary columns whatever
its BC label, i.e. it is Dirichlet — replicated here, so the system is
never singular in this branch.  This makes the reference's
vertical-plane overturning Poisson (notebook 02: 5,000 sweeps, BCs
['fixed','fixed']) a one-shot exact solve.

Boundary conditions (y):
- ``fixed``: boundary rows are Dirichlet data taken from ``S0`` (zeros or
  the user's icbc), moved to the right-hand side;
- ``extend``: the fixed point of the reference's extend pre-pass satisfies
  S[0,:] == S[1,:] (numbas.py:284-310), so the boundary-pointing weight of
  the adjacent row folds onto its diagonal and the boundary rows are
  reconstructed by a row copy afterwards.

The pure-Neumann gauge: with ``extend`` at both ends the m=0 (zonal-mean)
block of a conservative operator is singular up to an additive constant —
the same nullspace SOR inherits.  The solve anchors that block (first
interior row's zonal mean pinned to 0) and then shifts the whole solution
so its active-cell mean matches ``S0``'s, making warm starts and the cold
(zero-mean) start well defined.  Solutions of singular problems are unique
only up to this gauge; tests compare against SOR after removing the mean.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["direct_applicable", "solve_direct",
           "masked_direct_applicable", "solve_direct_masked"]



def _mm(a, b):
    """Matmul at full float32 (or float64) precision: a GPU would
    otherwise run float32 products in TF32, about three decimal digits,
    and lose the direct solve's machine-precision residual."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)

def _offset_groups(offsets):
    """Split offsets by dy in {-1, 0, +1}; None if any |dy| > 1."""
    groups = {-1: [], 0: [], 1: []}
    for k, (dy, dx) in enumerate(offsets):
        if abs(dy) > 1 or abs(dx) > 1:
            return None
        groups[dy].append((k, dx))
    return groups


def _sym_x_bands(spec, S_shape):
    """Per-row bands for the non-periodic symmetric-x branch, or None.

    Qualifies a 2-D spec with fixed/extend BCs on BOTH dims whose trailing
    (x) coupling is x-invariant and left-right symmetric per row and whose
    cross/advective terms vanish (offsets only (±1,0)/(0,±1)).  The folded
    x-operator is then c(y)·T0 with T0 a fixed symmetric tridiagonal, so one
    host-side eigendecomposition of T0 block-diagonalises the whole system
    into nxi real tridiagonal solves in y (see :func:`solve_direct`).
    """
    ny, nx = S_shape[-2:]
    if ny < 3 or nx < 4:
        return None
    w = np.asarray(spec.w)
    w0 = np.asarray(spec.w0)
    active = np.asarray(spec.active)
    if w.ndim != 3 or w0.ndim != 2 or active.ndim != 2:
        return None                       # batched weights: not supported
    if active.shape != (ny, nx):
        return None
    interior = np.zeros((ny, nx), bool)
    interior[1:-1, 1:-1] = True           # boundary rows AND columns fixed
    if not np.array_equal(active, interior):
        return None
    rows, cols = slice(1, ny - 1), slice(1, nx - 1)
    # bitwise x-invariance over the interior (builders apply identical
    # per-row ops to x-invariant coefficient planes)
    if not (w[:, rows, cols] == w[:, rows, 1:2]).all():
        return None
    if not (w0[rows, cols] == w0[rows, 1:2]).all():
        return None
    nyi = ny - 2
    sub = np.zeros(nyi)
    sup = np.zeros(nyi)
    ce = np.zeros(nyi)
    cw = np.zeros(nyi)
    for k, (dy, dx) in enumerate(spec.offsets):
        if abs(dy) > 1 or abs(dx) > 1:
            return None
        if dy != 0 and dx != 0:
            # diagonal terms do not separate — but the standard-2D(+E)
            # compilers emit the cross offsets even when B == 0 (zero
            # weight planes); those are inert and qualify
            if (w[k] == 0).all():
                continue
            return None
        wk = w[k, rows, 1]
        if dy == -1:
            sub = sub + wk
        elif dy == 1:
            sup = sup + wk
        elif dx == 1:
            ce = ce + wk
        elif dx == -1:
            cw = cw + wk
        else:
            return None
    # left-right symmetry (staggered builders give this bitwise whenever the
    # plane is x-invariant: east = shift(C)[i] = C[i+1] = C[i] = west)
    if not (ce == cw).all():
        return None
    return {"sub": sub, "sup": sup, "c": ce, "w0": w0[rows, 1]}


def direct_applicable(spec, S_shape) -> bool:
    """True when :func:`solve_direct` handles this problem exactly.

    Requirements (checked on the concrete spec arrays — call before jit):
    2-D non-biharmonic spec, neighbor reach |dy| <= 1 and |dx| <= 1,
    fixed/extend y, unbatched x-invariant weights, and a fully active
    interior (no land/sea mask holes); x either periodic (any offsets,
    complex Fourier symbols) or fixed/extend with left-right symmetric
    coupling and no cross terms (real eigenbasis of the folded tridiagonal
    x-operator — the standard-2D family qualifies).  1-D specs (the
    GeoAdjustment / RefStateSWM family) are pure tridiagonal systems and
    qualify with fixed or extend BCs and a fully active interior — no
    x-invariance needed.
    """
    if spec.ndim == 1:
        if spec.bcs[0] not in ("fixed", "extend"):
            return False
        if any(abs(o[0]) > 1 for o in spec.offsets):
            return False
        w = np.asarray(spec.w)
        active = np.asarray(spec.active)
        if w.ndim != 2 or active.ndim != 1:
            return False
        n = S_shape[-1]
        if n < 3 or active.shape != (n,):
            return False
        interior = np.zeros(n, bool)
        interior[1:-1] = True
        return np.array_equal(active, interior)
    if spec.ndim != 2 or spec.bih:
        return False
    if spec.bcs[-2] not in ("fixed", "extend"):
        return False
    if spec.bcs[-1] in ("fixed", "extend"):
        # non-periodic x: symmetric-coupling eigenbasis branch
        return _sym_x_bands(spec, S_shape) is not None
    if spec.bcs[-1] != "periodic":
        return False
    if _offset_groups(spec.offsets) is None:
        return False
    w = np.asarray(spec.w)
    w0 = np.asarray(spec.w0)
    active = np.asarray(spec.active)
    if w.ndim != 3 or w0.ndim != 2 or active.ndim != 2:
        return False                      # batched weights: not supported
    ny, nx = S_shape[-2:]
    if ny < 3 or active.shape != (ny, nx):
        return False
    # fully active interior (the mask path needs iteration), inactive edges
    interior = np.zeros((ny, nx), bool)
    interior[1:-1, :] = True
    if not np.array_equal(active, interior):
        return False
    # exact x-invariance: builders apply identical per-row ops to x-invariant
    # coefficient planes, so equality is bitwise when it holds at all
    rows = slice(1, ny - 1)
    if not (w[:, rows] == w[:, rows, :1]).all():
        return False
    return bool((w0[rows] == w0[rows, :1]).all())


def _thomas_modes(sub, dia, sup, rhs):
    """Thomas elimination vectorised over the trailing mode axis.

    sub/dia/sup: (n, M) — sub[0] and sup[-1] are ignored; rhs: (..., n, M).
    Returns x with rhs's shape.

    Sequential elimination (ops/tridiag.tridiag_solve): the low modes'
    systems are only weakly diagonally dominant, where the log-depth
    (associative-scan) elimination loses accuracy — on a 2048^2 global
    Poisson in float32 it landed 2e-2 from the float64 solution on the CPU
    and 0.8 on an H100 (700 W); the sequential one lands 6e-4 on the CPU,
    the float32 conditioning bound.
    """
    from .tridiag import tridiag_solve

    x = tridiag_solve(jnp.moveaxis(sub, 0, -1)[..., 1:],
                      jnp.moveaxis(dia, 0, -1),
                      jnp.moveaxis(sup, 0, -1)[..., :-1],
                      jnp.moveaxis(rhs, -2, -1))
    return jnp.moveaxis(x, -1, -2)


@partial(jax.jit, static_argnames=("offsets", "extend", "gauge", "project"))
def _solve_direct_jit(w_rows, w0_rows, g, S0, offsets, extend, gauge,
                      project):
    # w_rows: (K, nyi) per-row weights; w0_rows: (nyi,)
    # g, S0: (..., ny, nx)
    ny, nx = S0.shape[-2:]
    nyi = ny - 2
    rdtype = S0.dtype
    cdtype = jnp.complex64 if rdtype == jnp.float32 else jnp.complex128
    m = jnp.arange(nx // 2 + 1)
    theta = (2.0 * np.pi / nx) * m.astype(rdtype)

    groups = _offset_groups(offsets)
    bands = {}
    for dy in (-1, 0, 1):
        band = jnp.zeros((nyi, nx // 2 + 1), cdtype)
        for k, dx in groups[dy]:
            phase = jnp.exp(1j * dx * theta).astype(cdtype)
            band = band + w_rows[k].astype(cdtype)[:, None] * phase[None, :]
        bands[dy] = band
    sub, sup = bands[-1], bands[1]
    dia = bands[0] + w0_rows.astype(cdtype)[:, None]

    rhs = -jnp.fft.rfft(g[..., 1:-1, :], axis=-1).astype(cdtype)
    bshape = jnp.broadcast_shapes(rhs.shape[:-2], S0.shape[:-2])
    rhs = jnp.broadcast_to(rhs, bshape + rhs.shape[-2:])
    if extend:
        # fixed point of the extend pre-pass: S[0] == S[1], S[-1] == S[-2]
        dia = dia.at[0].add(sub[0])
        dia = dia.at[-1].add(sup[-1])
        sub = sub.at[0].set(0.0)
        sup = sup.at[-1].set(0.0)
        if gauge:
            if project:
                # least-squares consistency: remove the component of the
                # zonal-mean rhs along the left nullvector (the constant,
                # for the symmetric conservative families).  An
                # inconsistent forcing (nonzero area integral) has no
                # steady solution — SOR drifts secularly there; this
                # returns the natural least-squares solution instead.
                b0 = rhs[..., :, 0]
                rhs = rhs.at[..., :, 0].set(
                    b0 - jnp.mean(b0, axis=-1, keepdims=True))
            # anchor the singular zonal-mean block: pins the first interior
            # row's m=0 coefficient to 0; the constant is restored by the
            # mean-gauge shift below
            scale = jnp.max(jnp.abs(w0_rows)).astype(cdtype)
            dia = dia.at[0, 0].set(scale)
            sub = sub.at[0, 0].set(0.0)
            sup = sup.at[0, 0].set(0.0)
            rhs = rhs.at[..., 0, 0].set(0.0)
    else:
        X0 = jnp.fft.rfft(S0[..., 0, :], axis=-1).astype(cdtype)
        X1 = jnp.fft.rfft(S0[..., -1, :], axis=-1).astype(cdtype)
        rhs = rhs.at[..., 0, :].add(-sub[0] * X0)
        rhs = rhs.at[..., -1, :].add(-sup[-1] * X1)

    X = _thomas_modes(sub, dia, sup, rhs)
    Sin = jnp.fft.irfft(X, n=nx, axis=-1).astype(rdtype)

    if extend:
        top, bot = Sin[..., :1, :], Sin[..., -1:, :]
        S = jnp.concatenate([top, Sin, bot], axis=-2)
        if gauge:
            S = S + (jnp.mean(S0[..., 1:-1, :], axis=(-2, -1), keepdims=True)
                     - jnp.mean(Sin, axis=(-2, -1), keepdims=True))
    else:
        top = jnp.broadcast_to(S0[..., :1, :], bshape + (1, nx))
        bot = jnp.broadcast_to(S0[..., -1:, :], bshape + (1, nx))
        S = jnp.concatenate([top, Sin, bot], axis=-2)
    return S


@partial(jax.jit, static_argnames=("extend_y",))
def _solve_direct_sym_jit(sub_rows, sup_rows, c_rows, w0_rows, Q, lam, g,
                          S0, extend_y):
    # sub/sup/c/w0_rows: (nyi,) per-row bands; Q/lam: eigenbasis of the
    # unit Dirichlet x-operator T0 (nxi, nxi)/(nxi,); g, S0: (..., ny, nx).
    # The transform pair is a pure matmul — exactly what the MXU wants.
    ny, nx = S0.shape[-2:]
    nyi, nxi = ny - 2, nx - 2
    rdtype = S0.dtype

    rhs = -g[..., 1:-1, 1:-1].astype(rdtype)
    bshape = jnp.broadcast_shapes(rhs.shape[:-2], S0.shape[:-2])
    rhs = jnp.broadcast_to(rhs, bshape + (nyi, nxi))
    # Dirichlet columns (S0 data; the reference never extends the trailing
    # dim) move to the right-hand side; the coupling weight into the first
    # interior column is c(y)
    rhs = rhs.at[..., :, 0].add(-c_rows * S0[..., 1:-1, 0])
    rhs = rhs.at[..., :, -1].add(-c_rows * S0[..., 1:-1, -1])
    rhsm = _mm(rhs, Q)                             # x -> eigenmode space

    sub = jnp.broadcast_to(sub_rows[:, None], (nyi, nxi))
    sup = jnp.broadcast_to(sup_rows[:, None], (nyi, nxi))
    dia = w0_rows[:, None] + c_rows[:, None] * lam[None, :]
    if extend_y:
        # fixed point of the extend pre-pass: S[0, 1:-1] == S[1, 1:-1]
        dia = dia.at[0].add(sub[0])
        dia = dia.at[-1].add(sup[-1])
        sub = sub.at[0].set(0.0)
        sup = sup.at[-1].set(0.0)
    else:
        X0 = _mm(S0[..., 0, 1:-1], Q)              # Dirichlet rows (icbc)
        X1 = _mm(S0[..., -1, 1:-1], Q)
        rhsm = rhsm.at[..., 0, :].add(-sub[0] * X0)
        rhsm = rhsm.at[..., -1, :].add(-sup[-1] * X1)

    X = _thomas_modes(sub, dia, sup, rhsm)
    Sin = _mm(X, Q.T).astype(rdtype)               # eigenmode space -> x

    left = jnp.broadcast_to(S0[..., 1:-1, :1], bshape + (nyi, 1))
    right = jnp.broadcast_to(S0[..., 1:-1, -1:], bshape + (nyi, 1))
    Sin = jnp.concatenate([left, Sin, right], axis=-1)
    if extend_y:
        # replicate the pre-pass row copy incl. its diagonal corner copies
        # (solver._apply_extend non-periodic stanza)
        def _edge_row(row):
            return jnp.concatenate([row[..., 1:2], row[..., 1:-1],
                                    row[..., -2:-1]], axis=-1)
        top = _edge_row(Sin[..., :1, :])
        bot = _edge_row(Sin[..., -1:, :])
        S = jnp.concatenate([top, Sin, bot], axis=-2)
    else:
        top = jnp.broadcast_to(S0[..., :1, :], bshape + (1, nx))
        bot = jnp.broadcast_to(S0[..., -1:, :], bshape + (1, nx))
        S = jnp.concatenate([top, Sin, bot], axis=-2)
    return S


def _solve_direct_sym(spec, S0):
    bands = _sym_x_bands(spec, jnp.shape(S0))
    nx = S0.shape[-1]
    nxi = nx - 2
    # The trailing dim is Dirichlet regardless of its BC label: the
    # reference's extend pre-pass touches rows only (numbas.py:284-310),
    # so non-periodic boundary COLUMNS keep their initial values —
    # replicated by solver._apply_extend and by this direct solve.  The
    # system is therefore never singular here (no gauge handling needed).
    T0 = np.zeros((nxi, nxi))
    idx = np.arange(nxi - 1)
    T0[idx, idx + 1] = 1.0
    T0[idx + 1, idx] = 1.0
    lam, Q = np.linalg.eigh(T0)
    extend_y = spec.bcs[-2] == "extend"
    dt = S0.dtype
    return _solve_direct_sym_jit(
        jnp.asarray(bands["sub"], dt), jnp.asarray(bands["sup"], dt),
        jnp.asarray(bands["c"], dt), jnp.asarray(bands["w0"], dt),
        jnp.asarray(Q, dt), jnp.asarray(lam, dt),
        jnp.asarray(spec.g, dt), S0, extend_y)


@partial(jax.jit, static_argnames=("extend", "gauge", "project"))
def _solve_direct_1d_jit(sub, dia, sup, g, S0, extend, gauge, project):
    # sub/dia/sup: (ni,) interior bands; g, S0: (..., n)
    n = S0.shape[-1]
    rdtype = S0.dtype
    rhs = -g[..., 1:-1].astype(rdtype)
    rhs = jnp.broadcast_to(rhs,
                           jnp.broadcast_shapes(rhs.shape[:-1],
                                                S0.shape[:-1]) + (n - 2,))
    if extend:
        dia = dia.at[0].add(sub[0])
        dia = dia.at[-1].add(sup[-1])
        sub = sub.at[0].set(0.0)
        sup = sup.at[-1].set(0.0)
        if gauge:
            if project:
                rhs = rhs - jnp.mean(rhs, axis=-1, keepdims=True)
            scale = jnp.max(jnp.abs(dia))
            dia = dia.at[0].set(scale)
            sup = sup.at[0].set(0.0)
            rhs = rhs.at[..., 0].set(0.0)
    else:
        rhs = rhs.at[..., 0].add(-sub[0] * S0[..., 0])
        rhs = rhs.at[..., -1].add(-sup[-1] * S0[..., -1])
    x = _thomas_modes(sub[:, None], dia[:, None], sup[:, None],
                      rhs[..., None])[..., 0]
    if extend:
        S = jnp.concatenate([x[..., :1], x, x[..., -1:]], axis=-1)
        if gauge:
            S = S + (jnp.mean(S0[..., 1:-1], axis=-1, keepdims=True)
                     - jnp.mean(x, axis=-1, keepdims=True))
    else:
        top = jnp.broadcast_to(S0[..., :1], rhs.shape[:-1] + (1,))
        bot = jnp.broadcast_to(S0[..., -1:], rhs.shape[:-1] + (1,))
        S = jnp.concatenate([top, x, bot], axis=-1)
    return S.astype(rdtype)


def _solve_direct_1d(spec, S0):
    n = S0.shape[-1]
    w = np.asarray(spec.w)[:, 1:n - 1]
    w0 = np.asarray(spec.w0)[1:n - 1]
    by = {off[0]: k for k, off in enumerate(spec.offsets)}
    sub = w[by[-1]] if -1 in by else np.zeros_like(w0)
    sup = w[by[1]] if 1 in by else np.zeros_like(w0)
    extend = spec.bcs[0] == "extend"
    gauge = project = False
    if extend:
        tol = 1e-10 * np.max(np.abs(w0))
        gauge = bool(np.max(np.abs(sub + sup + w0)) <= tol)
        if gauge:
            dia0 = w0.copy()
            dia0[0] += sub[0]
            dia0[-1] += sup[-1]
            colsum = dia0.copy()
            colsum[:-1] += sub[1:]
            colsum[1:] += sup[:-1]
            project = bool(np.max(np.abs(colsum)) <= tol)
    dt = S0.dtype
    return _solve_direct_1d_jit(jnp.asarray(sub, dt), jnp.asarray(w0, dt),
                                jnp.asarray(sup, dt),
                                jnp.asarray(spec.g, dt), S0,
                                extend, gauge, project)


# ---------------------------------------------------------------------------
# masked domains: capacitance-matrix (Schur-on-the-holes) correction
# ---------------------------------------------------------------------------

# dense-capacitance budget: p holes cost p batched spectral solves (chunked)
# plus one (p[+1])^2 dense factorisation — island/topography-scale masks
# (the Ishida interior-rectangle tests, archipelagos); continent-scale masks
# (the 180x360 ocean fixture has ~19k holes) go to multigrid instead
MAX_HOLES = 2048
_UNIT_CHUNK = 256      # unit-response solves per batched call (memory cap)


def masked_direct_applicable(spec_full, holes, max_holes: int = MAX_HOLES,
                             S_shape=None) -> bool:
    """True when :func:`solve_direct_masked` handles this problem exactly:
    the UNMASKED operator qualifies for :func:`solve_direct` (2-D branch)
    and the interior hole count fits the dense-capacitance budget."""
    holes = np.asarray(holes)
    if S_shape is None:
        S_shape = holes.shape
    if spec_full.ndim != 2:
        return False
    if not direct_applicable(spec_full, S_shape):
        return False
    ny, nx = holes.shape[-2:]
    if holes[0, :].any() or holes[-1, :].any():
        return False                      # boundary rows are not "holes"
    p = int(holes.sum())
    return 0 < p <= max_holes


def solve_direct_masked(spec_full, holes, S0):
    """Exact one-shot solve on a masked (irregular) 2-D domain.

    The reference's flagship masked-ocean problems
    (/root/reference/tests/test_Poisson.py:44-65) stay iterative in round 2
    because masking breaks the x-invariance the spectral solve needs.  The
    capacitance-matrix method restores the direct path: the masked system
    equals the UNMASKED x-invariant operator ``L`` (``spec_full``, built
    with a fully active interior — active-cell weights are identical, only
    the hole rows differ) with the ``p`` hole cells pinned at their ``S0``
    values.  Writing ``y = y0 + R mu`` with ``y0 = L^{-1} b`` and ``R`` the
    unit responses at the holes, the pin conditions give a dense p x p
    capacitance system ``C mu = S0_holes - y0_holes`` with
    ``C[j, k] = (L^{-1} e_k)[hole_j]`` — ``p`` batched spectral solves
    (chunked) plus one dense solve.

    Singular (extend + conservative, pure-Neumann gauge) operators get the
    classic bordered system: an explicit constant column and the
    consistency row ``sum(mu) = sum(g)`` close the gauge, which the masked
    problem itself fixes through its Dirichlet holes.

    ``S0`` (and ``spec_full.g``) may carry leading batch dims: the hole
    pattern — and therefore the capacitance factorisation — is shared
    across the batch, so a batch costs the same ``p`` unit solves plus one
    multi-RHS dense solve.  Returns S shaped like ``S0`` with hole cells
    at exactly ``S0``.  Machine-precision residual on the active cells
    (tests/test_direct.py).
    """
    import dataclasses

    holes_np = np.asarray(holes)
    if not masked_direct_applicable(spec_full, holes_np,
                                    S_shape=jnp.shape(S0)):
        raise ValueError(
            "solve_direct_masked needs an unmasked spec qualifying for "
            "solve_direct and an interior hole count within MAX_HOLES; "
            "use multigrid or SOR for this problem")
    S0 = jnp.asarray(S0)
    batch = S0.shape[:-2]
    ny, nx = holes_np.shape
    yj, xj = np.nonzero(holes_np)
    p = len(yj)
    dt = S0.dtype

    # gauge bookkeeping mirrors solve_direct's host-side detection
    singular = False
    if spec_full.bcs[-2] == "extend" and spec_full.bcs[-1] == "periodic":
        w = np.asarray(spec_full.w)[:, 1:ny - 1, 0]
        w0 = np.asarray(spec_full.w0)[1:ny - 1, 0]
        tol = 1e-10 * np.max(np.abs(w0))
        singular = bool(np.max(np.abs(w.sum(axis=0) + w0)) <= tol)

    y0 = solve_direct(spec_full, S0)

    # unit responses, chunked batched solves: A r = e_k  <=>  g = -e_k
    cols = []
    zero_S = jnp.zeros((ny, nx), dt)
    for c0 in range(0, p, _UNIT_CHUNK):
        sel = slice(c0, min(c0 + _UNIT_CHUNK, p))
        nb = sel.stop - sel.start
        E = np.zeros((nb, ny, nx), dtype=np.asarray(spec_full.g).dtype)
        E[np.arange(nb), yj[sel], xj[sel]] = -1.0
        spec_u = dataclasses.replace(spec_full, g=jnp.asarray(E))
        R = solve_direct(spec_u, jnp.broadcast_to(zero_S, (nb, ny, nx)))
        cols.append(np.asarray(R)[:, yj, xj])      # (nb, p) responses
    C = np.concatenate(cols, axis=0).T             # C[j, k] = r_k[hole_j]

    # multi-RHS solve over the batch: d has shape (p, *batch)
    g_np = np.asarray(spec_full.g)
    d = np.moveaxis(np.asarray(S0)[..., yj, xj] - np.asarray(y0)[..., yj, xj],
                    -1, 0).reshape(p, -1)
    nb_rhs = d.shape[1]
    if singular:
        # bordered system: explicit constant DOF + the consistency row
        # sum(b + mu) = 0 with b = -g over the interior rows
        gsum = np.broadcast_to(g_np, batch + (ny, nx))[..., 1:-1, :] \
            .sum(axis=(-2, -1)).reshape(1, nb_rhs)
        M = np.zeros((p + 1, p + 1))
        M[:p, :p] = C
        M[:p, p] = 1.0
        M[p, :p] = 1.0
        sol = np.linalg.solve(M, np.concatenate([d, gsum], axis=0))
        mu, const = sol[:p], sol[p]
    else:
        mu = np.linalg.solve(C, d)
        const = np.zeros(nb_rhs)

    # assemble: one more batched pass accumulating R mu is avoided by
    # re-solving once with the holes' sources folded into g
    gmu = np.zeros(batch + (ny, nx), dtype=g_np.dtype)
    gmu[..., yj, xj] = -np.moveaxis(mu.reshape((p,) + batch), 0, -1)
    spec_c = dataclasses.replace(spec_full, g=jnp.asarray(g_np + gmu))
    S = solve_direct(spec_c, S0) \
        + jnp.asarray(const.reshape(batch + (1, 1)), dt)
    # pin the holes exactly (they satisfy the pin up to rounding already)
    S = jnp.where(jnp.asarray(holes_np), S0, S)
    return S


def solve_direct(spec, S0):
    """Solve the spec's folded system exactly (see module docstring).

    ``S0`` supplies Dirichlet boundary rows (fixed BC; zeros or icbc), the
    gauge mean for singular extend-extend problems, and any leading batch
    shape.  Check :func:`direct_applicable` first — inapplicable specs
    raise.  Returns S shaped like ``S0`` (broadcast with ``spec.g``).
    """
    if not direct_applicable(spec, jnp.shape(S0)):
        raise ValueError(
            "solve_direct needs a 2-D non-biharmonic spec with x-invariant "
            "unbatched weights, a fully active interior (no mask holes), "
            "fixed/extend y, and either periodic x (|dy|,|dx| <= 1 offsets) "
            "or fixed/extend x with symmetric coupling and no cross terms; "
            "or a 1-D spec with fixed/extend BCs; this problem does not "
            "qualify — use the iterative solver")
    S0 = jnp.asarray(S0)
    if spec.ndim == 1:
        return _solve_direct_1d(spec, S0)
    if spec.bcs[-1] != "periodic":
        return _solve_direct_sym(spec, S0)
    ny = S0.shape[-2]
    w_rows = jnp.asarray(spec.w)[:, 1:ny - 1, 0]
    w0_rows = jnp.asarray(spec.w0)[1:ny - 1, 0]
    g = jnp.asarray(spec.g, S0.dtype)
    extend = spec.bcs[-2] == "extend"
    gauge = project = False
    if extend:
        # conservative row sums (w0 + sum_k w_k == 0) make the zonal-mean
        # block singular after the extend fold: its nullspace is the
        # constant vector, exactly SOR's pure-Neumann gauge freedom
        w = np.asarray(spec.w)[:, 1:ny - 1, 0]
        w0 = np.asarray(spec.w0)[1:ny - 1, 0]
        tol = 1e-10 * np.max(np.abs(w0))
        rowsum = w.sum(axis=0) + w0
        gauge = bool(np.max(np.abs(rowsum)) <= tol)
        if gauge:
            # symmetric-conservative (column sums of the folded m=0 block
            # also vanish): the left nullvector is the constant, so the
            # least-squares projection is a plain mean removal
            groups = _offset_groups(spec.offsets)
            sub0 = sum(w[k] for k, dx in groups[-1]) if groups[-1] else 0 * w0
            sup0 = sum(w[k] for k, dx in groups[1]) if groups[1] else 0 * w0
            dia0 = w0 + (sum(w[k] for k, dx in groups[0]) if groups[0]
                         else 0 * w0)
            dia0 = dia0.copy()
            dia0[0] += sub0[0]
            dia0[-1] += sup0[-1]
            colsum = dia0.copy()
            colsum[:-1] += sub0[1:]
            colsum[1:] += sup0[:-1]
            project = bool(np.max(np.abs(colsum)) <= tol)
    return _solve_direct_jit(w_rows, w0_rows, g, S0, spec.offsets, extend,
                             gauge, project)
