# -*- coding: utf-8 -*-
"""Geometric multigrid for the standard-2D, standard-3D and biharmonic
stencil families.

The reference ships a broken experimental multigrid (apps.py:1061-1135,
imports a non-existent module); :func:`xinvert_tpu.models.api.invert_MultiGrid`
already provides its working coarse-to-fine intent.  This module goes
further: a true V-cycle on the residual equation with coefficient
coarsening, full-weighting restriction and bilinear prolongation — reducing
iterations-to-tolerance from O(N) SOR sweeps to O(10) cycles, masks
included.

Everything is jit-compatible with a static level hierarchy; smoothing uses
the same red-black engine as the main solver, so each level runs on-device
(and through the fused CUDA sweep kernel where solver.choose_sweep picks
it).

Grid-size support per dim: even sizes coarsen cell-wise (n -> n/2), odd
sizes vertex-wise (n -> (n+1)/2).  Periodic dims must be even (the sphere's
lon dim always is).  3-D problems SEMICOARSEN: only (y, x) coarsen, the z
column stays fine (the omega equation's f^2/N^2 stiffness lives in z and is
handled by z-line smoothing, so coarsening z would only slow convergence).

Smoothers (``solve_mg(smoother=None)`` auto-selects from the operator's
coupling anisotropy):
- ``point``: red-black Gauss-Seidel — quasi-isotropic coefficients;
- ``xline``: zebra x-line relaxation (exact cyclic-tridiagonal row solves
  via the Thomas kernels) — strong x coupling, e.g. the 1/cos^2(lat) polar
  metric of full-sphere grids, which stalls point smoothing (~1e-2
  residual floor) but converges in ~8 line-smoothed cycles to 1e-10;
- ``zline``: zebra z-line relaxation — the omega equation's strong
  f^2 (delx/delz)^2 vertical coupling;
- ``zxline``: alternating z- then x-line relaxation — both anisotropies at
  once (full-sphere 3-D omega).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from . import stencil
from .solver import _sweep_with, _color_relax, _neighbor_sum
from .grid import optimal_omega

__all__ = ["build_pyramid_standard2d", "build_pyramid_standard3d",
           "build_pyramid_general2d", "build_pyramid_general3d",
           "build_pyramid_bih2d", "solve_mg", "MGLevel"]


@partial(jax.tree_util.register_dataclass,
         data_fields=["spec", "omega"],
         meta_fields=["odd", "masked", "smoother"])
@dataclasses.dataclass(frozen=True)
class MGLevel:
    spec: object                 # StencilSpec
    omega: jnp.ndarray
    odd: Tuple[bool, bool]       # per coarsened dim (the trailing y, x):
    #                              vertex (odd) vs cell coarsening
    masked: bool = False         # fine problem has interior inactive cells
    smoother: Optional[str] = None   # auto-selected at BUILD time (where the
    #                              coefficient planes are concrete) so that
    #                              solve_mg stays jit/shard-composable


def _auto_smoother(spec) -> str:
    """Coupling-anisotropy smoother selection (host-side decision; called
    at pyramid build time, not under a trace).

    Line relaxation along any axis whose coupling dominates the others by
    >10x anywhere (the 1/cos^2 polar metric in x; f^2 (delx/delz)^2
    stiffness in z, amplified by semicoarsening).  The coupling ratio is
    reduced ON DEVICE and only the scalar is fetched, not the full
    coefficient planes."""
    nd = spec.ndim
    offs = {tuple(o): k for k, o in enumerate(spec.offsets)}
    w = spec.w
    act = spec.active
    floor = np.finfo(np.dtype(spec.w0.dtype)).tiny

    def coupling(axis):
        unit = tuple(1 if i == axis else 0 for i in range(nd))
        nunit = tuple(-u for u in unit)
        if unit not in offs or nunit not in offs:
            return None
        return jnp.abs(w[offs[unit]] + w[offs[nunit]])

    if nd == 2 and bool(jnp.any(act)):
        cx, cy = coupling(1), coupling(0)
        ratio = (float(_coupling_ratio(act, cx, cy, floor))
                 if cx is not None and cy is not None else 0.0)
        return "xline" if ratio > 10.0 else "point"
    if nd == 3 and bool(jnp.any(act)):
        # semicoarsening quadruples the relative z coupling per level, so
        # z-lines are ALWAYS needed once the hierarchy has depth; add
        # x-lines for the polar 1/cos^2 metric
        cy, cx = coupling(1), coupling(2)
        rx = (float(_coupling_ratio(act, cx, cy, floor))
              if cx is not None and cy is not None else 0.0)
        return "zxline" if rx > 10.0 else "zline"
    return "point"


@jax.jit
def _coupling_ratio(act, cnum, cden, floor):
    """max over active cells of cnum/cden — module-level jit so repeated
    pyramid builds hit the compile cache (a nested closure would retrace
    per call and bake the active plane in as a program constant)."""
    return jnp.max(jnp.where(act, cnum / jnp.maximum(cden, floor), 0.0))


# ---------------------------------------------------------------- transfer

def _coarsen_axis_vertex(a, axis):
    """Sample every other point (vertex-centred), keeping both ends."""
    n = a.shape[axis]
    idx = jnp.arange(0, n, 2)
    return jnp.take(a, idx, axis=axis)


def _coarsen_axis_cell(a, axis):
    """Average adjacent pairs (cell-centred)."""
    n = a.shape[axis]
    sl0 = [slice(None)] * a.ndim
    sl1 = [slice(None)] * a.ndim
    sl0[axis] = slice(0, n, 2)
    sl1[axis] = slice(1, n, 2)
    return 0.5 * (a[tuple(sl0)] + a[tuple(sl1)])


def _coarsen_plane(a, odd):
    for ax_rel, o in enumerate(odd):
        ax = a.ndim - 2 + ax_rel
        a = _coarsen_axis_vertex(a, ax) if o else _coarsen_axis_cell(a, ax)
    return a


def _coarsen_mask(mask, odd):
    """Conservative coarse mask: a coarse point is active only if ALL fine
    points in its support are.  Odd (vertex-coarsened) axes pool the full
    3-point support {2i-1, 2i, 2i+1} so thin masked features on skipped
    rows/cols cannot vanish from coarse levels; even (cell) axes pool the
    pair."""
    m = mask
    for ax_rel, o in enumerate(odd):
        ax = m.ndim - 2 + ax_rel
        if o:
            lo = jnp.concatenate(
                [jax.lax.slice_in_dim(m, 0, 1, axis=ax),
                 jax.lax.slice_in_dim(m, 0, m.shape[ax] - 1, axis=ax)],
                axis=ax)
            hi = jnp.concatenate(
                [jax.lax.slice_in_dim(m, 1, m.shape[ax], axis=ax),
                 jax.lax.slice_in_dim(m, m.shape[ax] - 1, m.shape[ax],
                                      axis=ax)], axis=ax)
            m = _coarsen_axis_vertex(lo & m & hi, ax)
        else:
            n = m.shape[ax]
            sl0 = [slice(None)] * m.ndim
            sl1 = [slice(None)] * m.ndim
            sl0[ax] = slice(0, n, 2)
            sl1[ax] = slice(1, n, 2)
            m = m[tuple(sl0)] & m[tuple(sl1)]
    return m


def _restrict_axis(r, axis, odd, periodic):
    """Full-weighting along one axis."""
    if odd:
        # vertex: (r[2i-1] + 2 r[2i] + r[2i+1]) / 4, one-sided at the ends
        if periodic:
            lo = jnp.roll(r, 1, axis)
            hi = jnp.roll(r, -1, axis)
        else:
            lo = jnp.concatenate(
                [jax.lax.slice_in_dim(r, 0, 1, axis=axis),
                 jax.lax.slice_in_dim(r, 0, r.shape[axis] - 1, axis=axis)],
                axis=axis)
            hi = jnp.concatenate(
                [jax.lax.slice_in_dim(r, 1, r.shape[axis], axis=axis),
                 jax.lax.slice_in_dim(r, r.shape[axis] - 1, r.shape[axis],
                                      axis=axis)], axis=axis)
        w = 0.25 * lo + 0.5 * r + 0.25 * hi
        return _coarsen_axis_vertex(w, axis)
    return _coarsen_axis_cell(r, axis)


def restrict(r, odd, bcs):
    for ax_rel, o in enumerate(odd):
        ax = r.ndim - 2 + ax_rel
        r = _restrict_axis(r, ax, o, bcs[ax_rel] == "periodic")
    return r


def _prolong_axis(e, axis, n_fine, odd, periodic):
    if odd:
        # vertex linear: p[2i] = e[i]; p[2i+1] = (e[i] + e[i+1]) / 2
        nxt = jnp.concatenate(
            [jax.lax.slice_in_dim(e, 1, e.shape[axis], axis=axis),
             jax.lax.slice_in_dim(e, e.shape[axis] - 1, e.shape[axis],
                                  axis=axis)], axis=axis) \
            if not periodic else jnp.roll(e, -1, axis)
        mid = 0.5 * (e + nxt)
        out = jnp.stack([e, mid], axis=axis + 1)
        shp = list(e.shape)
        shp[axis] = 2 * e.shape[axis]
        out = out.reshape(shp)
        return jax.lax.slice_in_dim(out, 0, n_fine, axis=axis)
    # cell: nearest-neighbor injection of each coarse cell into its pair
    out = jnp.stack([e, e], axis=axis + 1)
    shp = list(e.shape)
    shp[axis] = 2 * e.shape[axis]
    return out.reshape(shp)


def prolong(e, fine_shape, odd, bcs):
    for ax_rel in reversed(range(2)):
        ax = e.ndim - 2 + ax_rel
        e = _prolong_axis(e, ax, fine_shape[ax_rel], odd[ax_rel],
                          bcs[ax_rel] == "periodic")
    return e


# ---------------------------------------------------------------- pyramid

def _pyramid_plan(shape, bcs, deltas, min_size, max_levels):
    """Static level plan [(shape, deltas, odd)], replicating the build
    loop's stopping rule (depth cap, min size, odd-periodic halt).  Pure
    host arithmetic on shapes — hashable, so it keys the jitted workers.

    ``shape``/``bcs`` cover only the COARSENED (trailing) dims; ``deltas``
    is the full per-dim spacing tuple, of which only the trailing
    ``len(shape)`` entries double per level (3-D semicoarsening keeps
    delz)."""
    out = []
    lvl = tuple(shape)
    dd = tuple(deltas)
    keep = len(dd) - len(lvl)
    while True:
        odd = tuple(n % 2 == 1 for n in lvl)
        out.append((lvl, dd, odd))
        nxt = tuple((n + 1) // 2 if n % 2 else n // 2 for n in lvl)
        if (len(out) >= max_levels or min(nxt) < min_size
                or any(bcs[i] == "periodic" and lvl[i] % 2
                       for i in range(len(lvl)))):
            return tuple(out)
        dd = dd[:keep] + tuple(d * 2 for d in dd[keep:])
        lvl = nxt


@partial(jax.jit, static_argnames=("plan", "bcs", "include_cross"))
def _build_levels_standard2d(A, B, C, F, mask, plan, bcs, include_cross):
    """All level specs of the standard-2D pyramid in ONE compiled program.

    The level loop unrolls at trace time (the plan is static); building
    eagerly instead costs ~250 separate dispatches and as many tiny
    first-call compiles at 2048^2."""
    specs = []
    for i, (shape, dd, odd) in enumerate(plan):
        specs.append(stencil.standard_2d(A, B, C, F, mask, dd, bcs,
                                         include_cross=include_cross))
        if i + 1 < len(plan):
            A = _coarsen_plane(A, odd)
            B = _coarsen_plane(B, odd)
            C = _coarsen_plane(C, odd)
            # conservative coarse mask (inactive if ANY fine support point
            # is inactive, full 3-point support on vertex axes): Dirichlet
            # anchor cells must SURVIVE coarsening — with extend+periodic
            # BCs they are the only thing fixing the constant nullspace,
            # and losing them makes coarse levels singular
            mask = _coarsen_mask(mask.astype(bool), odd)
            F = jnp.zeros(plan[i + 1][0], F.dtype)  # rhs = the residual
    return tuple(specs)


def build_pyramid_standard2d(A, B, C, F, Fdef, deltas, bcs,
                             min_size: int = 15,
                             max_levels: int = 10) -> List[MGLevel]:
    """Coefficient pyramid for d/dy(A Sy + B Sx) + d/dx(B Sy + C Sx) = F.

    Level 0 is the fine problem; deeper levels re-discretise the coarsened
    coefficients on doubled spacings.  BC types carry through unchanged:
    the error equation inherits the fine operator's boundary behaviour
    (an extend/Neumann-like boundary needs an extend coarse boundary, else
    the boundary error component is uncorrectable and the cycle stalls).
    """
    A = jnp.asarray(A)
    B = jnp.asarray(B) if not np.isscalar(B) else jnp.zeros_like(A) + B
    C = jnp.asarray(C)
    F = jnp.asarray(F)
    mask = jnp.asarray(Fdef)
    # host decisions hoisted out of the jitted worker (scalar fetches only)
    is_masked = not bool(jnp.all(mask))
    include_cross = bool(jnp.any(B != 0))

    plan = _pyramid_plan(F.shape[-2:], tuple(bcs), tuple(deltas),
                         min_size, max_levels)
    specs = _build_levels_standard2d(A, B, C, F, mask, plan=plan,
                                     bcs=tuple(bcs),
                                     include_cross=include_cross)
    # red-black Gauss-Seidel (omega ~ 1) is the right SMOOTHER; the
    # near-2 'optimal' SOR factor kills the smoothing property.  The
    # coarsest level iterates to convergence, so it gets the optimal
    # factor.
    levels = [MGLevel(spec=sp, omega=jnp.asarray(1.0), odd=odd,
                      masked=is_masked)
              for sp, (shape, dd, odd) in zip(specs, plan)]
    levels[-1] = dataclasses.replace(
        levels[-1], omega=jnp.asarray(optimal_omega(plan[-1][0])))
    return _stamp_smoother(levels)


def _ddy(p, d):
    """Central-difference d/dy of a coefficient plane (one-sided edges —
    boundary rows are inactive or extend-copied, so the edge values only
    steer the error equation weakly)."""
    g = (jnp.roll(p, -1, axis=-2) - jnp.roll(p, 1, axis=-2)) / (2.0 * d)
    g = g.at[..., 0, :].set((p[..., 1, :] - p[..., 0, :]) / d)
    g = g.at[..., -1, :].set((p[..., -1, :] - p[..., -2, :]) / d)
    return g


def _ddx(p, d):
    g = (jnp.roll(p, -1, axis=-1) - jnp.roll(p, 1, axis=-1)) / (2.0 * d)
    g = g.at[..., 0].set((p[..., 1] - p[..., 0]) / d)
    g = g.at[..., -1].set((p[..., -1] - p[..., -2]) / d)
    return g


@partial(jax.jit, static_argnames=("plan", "bcs"))
def _build_levels_standard2d_e(A, B, C, D, E, F, mask, plan, bcs):
    """All level specs of the standard-2D+Eψ pyramid in one compiled
    program (see _build_levels_standard2d for why).

    Level 0 is the exact reference discretisation
    (stencil.standard_2d_e — parity with the SOR answer).  Coarser levels
    re-express the operator in GENERAL form with first-order upwind
    advection: the flux cross terms hide advection —

        d/dy(B Sx) + d/dx(C Sy) = (B+C) Sxy + B_y Sx + C_x Sy

    (for the standardised Stommel/Gill-Matsuno forms B = -C = -f this is
    exactly the beta term, -beta Sx), and on doubled spacings the
    centered cross-flux discretisation loses diagonal dominance and the
    smoother diverges (measured: residual growth from level 2 of the
    65x128 Stommel_test pyramid).  The general-form coarse operator

        A Syy + (B+C) Syx + D Sxx + (A_y + C_x) Sy + (D_x + B_y) Sx + E S

    upwinds its advective terms with the per-cell sign normalisation, so
    coarse smoothing is robust while the converged answer remains the
    fine centered discretisation (coarse levels only correct error)."""
    def _fill_stagger_nan(p):
        """The half-grid staggering leaves a NaN leading row/column
        (problems._half); level 0 is immune (finalisation zeroes inactive
        cells) but the coarse derivative stencils would drag it into
        active interior cells — fill with the adjacent genuine value."""
        r0 = p[..., 0, :]
        p = p.at[..., 0, :].set(jnp.where(jnp.isfinite(r0), r0,
                                          p[..., 1, :]))
        c0 = p[..., :, 0]
        p = p.at[..., :, 0].set(jnp.where(jnp.isfinite(c0), c0,
                                          p[..., :, 1]))
        return p

    specs = []
    for i, (shape, dd, odd) in enumerate(plan):
        if i == 0:
            specs.append(stencil.standard_2d_e(A, B, C, D, E, F, mask, dd,
                                               bcs))
            A, B, C, D, E = (_fill_stagger_nan(p) for p in (A, B, C, D, E))
        else:
            dely, delx = dd[-2], dd[-1]
            Ag, Bg, Cg = A, B + C, D
            Dg = _ddy(A, dely) + _ddx(C, delx)
            Eg = _ddx(D, delx) + _ddy(B, dely)
            s = _upwind_sign(Ag, Cg)
            specs.append(stencil.general_2d(Ag, Bg, Cg, Dg, Eg, E, F,
                                            mask, dd, bcs, upwind=s))
        if i + 1 < len(plan):
            A = _coarsen_plane(A, odd)
            B = _coarsen_plane(B, odd)
            C = _coarsen_plane(C, odd)
            D = _coarsen_plane(D, odd)
            E = _coarsen_plane(E, odd)
            mask = _coarsen_mask(mask.astype(bool), odd)
            F = jnp.zeros(plan[i + 1][0], F.dtype)  # rhs = the residual
    return tuple(specs)


def build_pyramid_standard2d_e(A, B, C, D, E, F, Fdef, deltas, bcs,
                               min_size: int = 15,
                               max_levels: int = 10) -> List[MGLevel]:
    """Coefficient pyramid for the standard-2D+Eψ family (round 5):
    d/dy(A Sy + B Sx) + d/dx(C Sy + D Sx) + E S = F — the reference's
    invert_standard_2D_test form (numbas.py:421-629), used by RefState-
    class, Fofonoff, Bretherton-Haidvogel and the standardised
    Gill-Matsuno/Stommel problems.

    The E plane coarsens like the flux coefficients (plane averaging) and
    re-enters each level's diagonal as ``E*dx^2`` through the level
    re-discretisation — the coarse error equation inherits the fine
    operator's screening/damping term, which is exactly what keeps the
    +Eψ operators nonsingular on every level.
    """
    A = jnp.asarray(A)
    zeros = jnp.zeros_like(A)
    B = jnp.asarray(B) if not np.isscalar(B) else zeros + B
    C = jnp.asarray(C) if not np.isscalar(C) else zeros + C
    D = jnp.asarray(D)
    E = jnp.asarray(E) if not np.isscalar(E) else zeros + E
    F = jnp.asarray(F)
    mask = jnp.asarray(Fdef)
    is_masked = not bool(jnp.all(mask))

    plan = _pyramid_plan(F.shape[-2:], tuple(bcs), tuple(deltas),
                         min_size, max_levels)
    specs = _build_levels_standard2d_e(A, B, C, D, E, F, mask, plan=plan,
                                       bcs=tuple(bcs))
    levels = [MGLevel(spec=sp, omega=jnp.asarray(1.0), odd=odd,
                      masked=is_masked)
              for sp, (shape, dd, odd) in zip(specs, plan)]
    # the near-2 Laplacian-optimal factor speeds the coarsest iterate-to-
    # convergence only when no advection hides in the cross fluxes; the
    # upwinded advective coarsest levels need plain GS (omega ~ 1), like
    # the general-family pyramid.  NOTE the antisymmetric case B = -C
    # (the standardised Stommel/Gill-Matsuno beta term) has B + C == 0
    # while carrying advection (B_y Sx + C_x Sy) — gate on the planes
    # being individually zero, not on their sum
    if not bool(jnp.any(B != 0) | jnp.any(C != 0)):
        levels[-1] = dataclasses.replace(
            levels[-1], omega=jnp.asarray(optimal_omega(plan[-1][0])))
    return _stamp_smoother(levels)


def _stamp_smoother(levels):
    """Record the auto-selected smoother on the finest level (build time is
    the one place the coefficient planes are guaranteed concrete)."""
    levels[0] = dataclasses.replace(levels[0],
                                    smoother=_auto_smoother(levels[0].spec))
    return levels


def build_pyramid_standard3d(A, B, C, F, Fdef, deltas, bcs,
                             min_size: int = 9,
                             max_levels: int = 10) -> List[MGLevel]:
    """Coefficient pyramid for d/dz(A Sz) + d/dy(B Sy) + d/dx(C Sx) = F
    (the QG-omega family, stencil.standard_3d / numbas.py:16-212).

    SEMICOARSENING: only the trailing (y, x) dims coarsen; the z column
    stays at full resolution on every level and its strong f^2/N^2
    coupling is handled by z-line smoothing.  Coefficients coarsen by
    plane averaging/sampling over (y, x); each level re-discretises on the
    doubled (dely, delx) with the original delz.
    """
    A = jnp.asarray(A)
    B = jnp.asarray(B)
    C = jnp.asarray(C)
    F = jnp.asarray(F)
    mask = jnp.asarray(Fdef).astype(bool)
    if mask.ndim == 2:
        mask = jnp.broadcast_to(mask[None], F.shape)
    is_masked = not bool(jnp.all(mask))

    nz = F.shape[0]
    plan = _pyramid_plan(F.shape[-2:], tuple(bcs)[1:], tuple(deltas),
                         min_size, max_levels)
    specs = _build_levels_standard3d(A, B, C, F, mask, plan=plan,
                                     bcs=tuple(bcs), nz=nz)
    levels = [MGLevel(spec=sp, omega=jnp.asarray(1.0), odd=odd,
                      masked=is_masked)
              for sp, (shape, dd, odd) in zip(specs, plan)]
    levels[-1] = dataclasses.replace(
        levels[-1], omega=jnp.asarray(optimal_omega((nz,) + plan[-1][0])))
    return _stamp_smoother(levels)


@partial(jax.jit, static_argnames=("plan", "bcs", "nz"))
def _build_levels_standard3d(A, B, C, F, mask, plan, bcs, nz):
    """All semicoarsened standard-3D level specs in one compiled program
    (see _build_levels_standard2d for why)."""
    specs = []
    for i, (shape, dd, odd) in enumerate(plan):
        specs.append(stencil.standard_3d(A, B, C, F, mask, dd, bcs))
        if i + 1 < len(plan):
            A = _coarsen_plane(A, odd)
            B = _coarsen_plane(B, odd)
            C = _coarsen_plane(C, odd)
            mask = _coarsen_mask(mask, odd)
            F = jnp.zeros((nz,) + plan[i + 1][0], F.dtype)
    return tuple(specs)


def _upwind_sign(A, C):
    """PER-CELL sign normalisation for coarse-level upwinding: +-1 such
    that s * (A, C) is locally the non-negative-diffusion convention.
    Several reference families (e.g. Stommel) carry globally NEGATIVE
    diffusion planes; a plane with regionally MIXED sign gets each
    region's own orientation — a single global sign would upwind the
    minority-sign region the destabilising (downwind) way and the coarse
    smoother could diverge there."""
    A, C = jnp.asarray(A), jnp.asarray(C)
    return jnp.where(A + C >= 0, 1.0, -1.0).astype(A.dtype)


def build_pyramid_general2d(A, B, C, D, E, F, G, Fdef, deltas, bcs,
                            min_size: int = 15,
                            max_levels: int = 10) -> List[MGLevel]:
    """Coefficient pyramid for the damped advective general-2D family
    A Syy + B Syx + C Sxx + D Sy + E Sx + F S = G (stencil.general_2d /
    numbas.py:988-1201 — Gill-Matsuno, Stommel, Stommel-Arons).

    Level 0 keeps the reference's centered first derivatives (parity);
    coarser levels re-discretise the plane-coarsened coefficients on
    doubled spacings with first-order UPWIND advection — the doubled
    spacings raise the cell Peclet number until the centered coarse
    operator loses diagonal dominance and smoothing diverges; upwind
    coarse operators only correct error, so the converged answer is still
    the fine (centered) discretisation.
    """
    planes = [jnp.asarray(p) if not np.isscalar(p)
              else jnp.zeros(jnp.shape(G)[-2:], jnp.asarray(G).dtype) + p
              for p in (A, B, C, D, E, F)]
    G = jnp.asarray(G)
    mask = jnp.asarray(Fdef).astype(bool)
    is_masked = not bool(jnp.all(mask))

    plan = _pyramid_plan(G.shape[-2:], tuple(bcs), tuple(deltas),
                         min_size, max_levels)
    specs = _build_levels_general2d(tuple(planes), G, mask, plan=plan,
                                    bcs=tuple(bcs))
    # omega ~ 1 on every level: plain Gauss-Seidel smoothing, and on
    # the (upwinded, M-matrix) coarsest level GS iterates robustly
    # where the near-2 Laplacian-optimal factor can diverge for
    # advection-dominated operators
    levels = [MGLevel(spec=sp, omega=jnp.asarray(1.0), odd=odd,
                      masked=is_masked)
              for sp, (shape, dd, odd) in zip(specs, plan)]
    return _stamp_smoother(levels)


@partial(jax.jit, static_argnames=("plan", "bcs"))
def _build_levels_general2d(planes, G, mask, plan, bcs):
    """All general-2D level specs in one compiled program (see
    _build_levels_standard2d for why).  Level 0 keeps centered advection
    (reference parity); coarser levels upwind with a per-level, per-cell
    sign (coarsening can move a mixed-sign plane's regional
    boundaries)."""
    planes = list(planes)
    specs = []
    Gl = G
    for i, (shape, dd, odd) in enumerate(plan):
        s = _upwind_sign(planes[0], planes[2])
        specs.append(stencil.general_2d(*planes, Gl, mask, dd, bcs,
                                        upwind=(0.0 if i == 0 else s)))
        if i + 1 < len(plan):
            planes = [_coarsen_plane(p, odd) for p in planes]
            mask = _coarsen_mask(mask, odd)
            Gl = jnp.zeros(plan[i + 1][0], G.dtype)
    return tuple(specs)


def build_pyramid_general3d(A, B, C, D, E, F, G, H, Fdef, deltas, bcs,
                            min_size: int = 9,
                            max_levels: int = 10) -> List[MGLevel]:
    """Coefficient pyramid for the general-3D family A Szz + B Syy + C Sxx
    + D Sz + E Sy + F Sx + G S = H (stencil.general_3d / numbas.py:746-984
    — the damped 3DOcean flow).

    SEMICOARSENING over (y, x) with the z column at full resolution, like
    :func:`build_pyramid_standard3d`; coarse levels upwind the advective
    D/E/F terms (see :func:`build_pyramid_general2d`).
    """
    H = jnp.asarray(H)
    planes = [jnp.asarray(p) if not np.isscalar(p)
              else jnp.zeros(H.shape[-3:], H.dtype) + p
              for p in (A, B, C, D, E, F, G)]
    mask = jnp.asarray(Fdef).astype(bool)
    if mask.ndim == 2:
        mask = jnp.broadcast_to(mask[None], H.shape[-3:])
    is_masked = not bool(jnp.all(mask))

    nz = H.shape[-3]
    plan = _pyramid_plan(H.shape[-2:], tuple(bcs)[1:], tuple(deltas),
                         min_size, max_levels)
    specs = _build_levels_general3d(tuple(planes), H, mask, plan=plan,
                                    bcs=tuple(bcs), nz=nz)
    levels = [MGLevel(spec=sp, omega=jnp.asarray(1.0), odd=odd,
                      masked=is_masked)
              for sp, (shape, dd, odd) in zip(specs, plan)]
    return _stamp_smoother(levels)


@partial(jax.jit, static_argnames=("plan", "bcs", "nz"))
def _build_levels_general3d(planes, H, mask, plan, bcs, nz):
    """All general-3D level specs in one compiled program (semicoarsened;
    per-level, per-cell upwind sign — see _build_levels_general2d)."""
    planes = list(planes)
    specs = []
    Hl = H
    for i, (shape, dd, odd) in enumerate(plan):
        s = _upwind_sign(planes[0], planes[2])
        specs.append(stencil.general_3d(*planes, Hl, mask, dd, bcs,
                                        upwind=(0.0 if i == 0 else s)))
        if i + 1 < len(plan):
            planes = [_coarsen_plane(p, odd) for p in planes]
            mask = _coarsen_mask(mask, odd)
            Hl = jnp.zeros((nz,) + plan[i + 1][0], H.dtype)
    return tuple(specs)


def build_pyramid_bih2d(coeffs, J, Fdef, deltas, bcs,
                        min_size: int = 15,
                        max_levels: int = 10) -> List[MGLevel]:
    """Coefficient pyramid for the general biharmonic family
    A Syyyy + B Syyxx + C Sxxxx + D Syy + E Syx + F Sxx + G Sy + H Sx
    + I S = J (stencil.general_2d_bih / numbas.py:1205-1586 — the
    Stommel-Munk gyre).

    ``coeffs`` is the tuple (A, B, C, D, E, F, G, H, I); each level
    re-discretises the plane-coarsened coefficients on doubled spacings.
    The folded system carries delx^4, handled by the V-cycle's residual
    scale.
    """
    J = jnp.asarray(J)
    cs = [jnp.asarray(c) if not np.isscalar(c)
          else jnp.zeros(J.shape[-2:], J.dtype) + c
          for c in coeffs]
    mask = jnp.asarray(Fdef).astype(bool)
    is_masked = not bool(jnp.all(mask))

    plan = _pyramid_plan(J.shape[-2:], tuple(bcs), tuple(deltas),
                         min_size, max_levels)
    specs = _build_levels_bih2d(tuple(cs), J, mask, plan=plan,
                                bcs=tuple(bcs))
    # every level relaxes with omega ~ 1 (the near-2 Laplacian-optimal
    # factor diverges on the 13-point stencil, cf. models/api._AUTO_OMEGA)
    levels = [MGLevel(spec=sp, omega=jnp.asarray(1.0), odd=odd,
                      masked=is_masked)
              for sp, (shape, dd, odd) in zip(specs, plan)]
    return _stamp_smoother(levels)


@partial(jax.jit, static_argnames=("plan", "bcs"))
def _build_levels_bih2d(cs, J, mask, plan, bcs):
    """All biharmonic level specs in one compiled program (see
    _build_levels_standard2d for why)."""
    cs = list(cs)
    specs = []
    Jl = J
    for i, (shape, dd, odd) in enumerate(plan):
        specs.append(stencil.general_2d_bih(*cs, Jl, mask, dd, bcs))
        if i + 1 < len(plan):
            cs = [_coarsen_plane(c, odd) for c in cs]
            mask = _coarsen_mask(mask, odd)
            Jl = jnp.zeros(plan[i + 1][0], J.dtype)
    return tuple(specs)


# ---------------------------------------------------------------- smoothers

def _smooth(level: MGLevel, S, n, kernels: bool = False):
    """n red-black SOR sweeps — the point smoother.  With ``kernels``
    (single-device, unbatched solves) each level asks
    ``solver.choose_sweep`` and runs the fused CUDA kernel where it picks
    it (the same n red-black sweeps): the fine-level smoothing is the bulk
    of a V-cycle's sweeps."""
    if kernels and n:
        from .solver import choose_sweep
        if choose_sweep(level.spec, S).kernel == "cuda":
            from .ops.sor2d import sor_sweeps
            return sor_sweeps(level.spec, S, level.omega, n)
    rr, rb = _color_relax(level.spec, level.omega)
    return jax.lax.fori_loop(
        0, n, lambda i, s: _sweep_with(level.spec, s, rr, rb), S)


def _zebra_line_sweep(spec, S, axis):
    """One zebra line iteration along ``axis`` (negative, core-relative):
    solve every odd line's (cyclic) tridiagonal exactly, then every even
    line's — parity is the checkerboard of the OTHER core dims, so
    same-parity lines do not couple through the off-axis offsets.

    Strong along-axis coupling (the 1/cos^2(lat) polar metric for x, the
    f^2 (delx/delz)^2 stiffness for z) sits INSIDE the line solve, so this
    smooths anisotropic problems that point relaxation cannot.  Inactive
    cells become identity rows (b=1, rhs=S) — exact Dirichlet handling
    inside the line.

    Line systems solve with the LOG-DEPTH batched Thomas
    (ops/tridiag.tridiag_cyclic_pscan): O(log n) steps per line instead of
    the sequential scan's 2n.
    """
    from .ops.tridiag import tridiag_cyclic_pscan
    from .solver import _apply_extend

    nd = spec.ndim
    offs = {tuple(o): k for k, o in enumerate(spec.offsets)}
    unit = tuple(1 if i == nd + axis else 0 for i in range(nd))
    nunit = tuple(-u for u in unit)
    kp, km = offs[unit], offs[nunit]
    active = spec.active
    periodic = spec.bcs[axis] == "periodic"

    def solve_parity(S, parity):
        acc = spec.g
        for k, off in enumerate(spec.offsets):
            if off[nd + axis] != 0:
                continue
            shifts = tuple(-o for o in off if o != 0)
            axes = tuple(ax - nd for ax, o in enumerate(off) if o != 0)
            acc = acc + spec.w[k] * jnp.roll(S, shift=shifts, axis=axes)
        # per-line system: a x_{i-1} + b x_i + c x_{i+1} = d along `axis`
        a_full = jnp.where(active, spec.w[km], 0.0)
        c_full = jnp.where(active, spec.w[kp], 0.0)
        b_full = jnp.where(active, spec.w0, 1.0)
        d_full = jnp.where(active, -acc, S)

        def lines(a):
            """Move `axis` last and flatten the rest to a batch of lines."""
            m = jnp.moveaxis(a, axis, -1)
            return m.reshape((-1, m.shape[-1])), m.shape

        a_l, mshape = lines(a_full)
        c_l, _ = lines(c_full)
        b_l, _ = lines(b_full)
        d_l, _ = lines(d_full)
        nlines = a_l.shape[0]
        if periodic:
            a0, cn = a_l[:, 0], c_l[:, -1]
        else:
            a0 = jnp.zeros(nlines, S.dtype)
            cn = jnp.zeros(nlines, S.dtype)
        sol = tridiag_cyclic_pscan(a_l[:, 1:], b_l, c_l[:, :-1], d_l,
                                   a0, cn)
        sol = jnp.moveaxis(sol.reshape(mshape), -1, axis)

        # checkerboard parity over the non-axis core dims
        par = 0
        core_shape = S.shape[-nd:]
        for ax in range(nd):
            if ax == nd + axis:
                continue
            par = par + jax.lax.broadcasted_iota(jnp.int32, core_shape, ax)
        take = (par % 2) == parity
        return jnp.where(jnp.logical_and(take, active), sol, S)

    S = _apply_extend(spec, S)
    S = solve_parity(S, 1)
    S = solve_parity(S, 0)
    return S


_SMOOTH_AXES = {"line": (-1,), "xline": (-1,), "zline": (-3,),
                "zxline": (-3, -1)}


def _smooth_line(level: MGLevel, S, n, axes=(-1,)):
    def one(i, s):
        for ax in axes:
            s = _zebra_line_sweep(level.spec, s, ax)
        return s
    return jax.lax.fori_loop(0, n, one, S)


def _residual(spec, S):
    """Folded-system residual scaled back to physical units (/ delx^2 is
    unnecessary: the coarse spec folds its own delx_c^2, and the restriction
    of the *folded* residual only differs by the constant (delx_c/delx_f)^2
    = 4, which we apply explicitly)."""
    r = _neighbor_sum(spec, S) + spec.w0 * S
    return jnp.where(spec.active, r, 0.0)


def _vcycle(levels: List[MGLevel], lvl: int, S, g_override,
            nu1: int, nu2: int, coarse_iters: int, alpha: float = 1.0,
            smoother: str = "point", kernels: bool = False):
    if smoother in _SMOOTH_AXES:
        axes = _SMOOTH_AXES[smoother]
        def sm(level, S, n):
            return _smooth_line(level, S, n, axes)
    else:
        def sm(level, S, n):
            return _smooth(level, S, n, kernels)
    level = levels[lvl]
    spec = level.spec
    if g_override is not None:
        spec = dataclasses.replace(spec, g=jnp.where(spec.active,
                                                     g_override, 0.0))
        level = dataclasses.replace(level, spec=spec)

    if lvl == len(levels) - 1:
        return sm(level, S, coarse_iters)

    S = sm(level, S, nu1)
    # residual of the folded system: sum w S + w0 S + g = 0
    r = _residual(spec, S)
    bcs2 = spec.bcs[-2:]          # only the trailing (y, x) dims coarsen
    r_c = restrict(r, level.odd, bcs2)
    # the error e solves M e = r, i.e. folded form M_c e + g_c = 0 with
    # g_c = -scale * r_c; the folded system carries the level's delx^2
    # (delx^4 for the biharmonic family), so scale = (delx_c/delx_f)^p
    g_c = (-16.0 if spec.bih else -4.0) * r_c
    e0 = jnp.zeros_like(levels[lvl + 1].spec.w0)
    e = _vcycle(levels, lvl + 1, e0, g_c, nu1, nu2, coarse_iters, alpha,
                smoother, kernels)
    corr = prolong(e, spec.w0.shape[-2:], level.odd, bcs2)
    # alpha < 1 damps the coarse-grid correction: with re-discretised
    # (non-Galerkin) coarse operators and irregular masks, the undamped
    # correction can over-shoot coastline modes and destabilise the cycle
    S = jnp.where(spec.active, S - alpha * corr, S)
    return sm(level, S, nu2)


@partial(jax.jit, static_argnames=("max_cycles", "nu1", "nu2",
                                   "coarse_iters", "alpha", "smoother",
                                   "kernels", "fmg"))
def _solve_mg_krylov_jit(levels, S0, g0, tol, max_cycles, nu1, nu2,
                         coarse_iters, alpha, smoother, kernels=False,
                         fmg=False):
    """V-cycle-preconditioned BiCGStab on the folded system.

    Plain coarse-grid correction fails on advection-dominated operators
    (the Stommel/Stommel-Arons beta terms): the coarse operator's phase
    error on characteristics is O(1), so the cycle stalls near ~0.95 per
    cycle.  Wrapping the SAME V-cycle as a Krylov preconditioner restores
    fast convergence (measured: Stommel-Arons 36x72 stalls at 3e-1 plain,
    reaches 3e-8 Krylov-wrapped).  Solves for the CORRECTION e with
    A e = r(S0), inactive cells pinned at zero, so icbc Dirichlet data in
    S0 rides through untouched.  ``fmg`` is accepted for uniform plumbing
    but ignored: the Krylov stage runs as a RESCUE from an already-warm
    iterate."""
    from jax.scipy.sparse.linalg import bicgstab

    spec = levels[0].spec
    if g0 is not None:
        spec = dataclasses.replace(spec, g=jnp.where(spec.active, g0, 0.0))
        levels = (dataclasses.replace(levels[0], spec=spec),) + \
            tuple(levels[1:])
    act = spec.active
    spec_l = dataclasses.replace(spec, g=jnp.zeros_like(spec.g))
    g_scale = jnp.maximum(jnp.max(jnp.abs(spec.g)),
                          jnp.asarray(jnp.finfo(spec.g.dtype).tiny,
                                      spec.g.dtype))

    def matvec(x):
        return jnp.where(act, _neighbor_sum(spec_l, x) + spec.w0 * x, x)

    def precond(r):
        return _vcycle(levels, 0, jnp.zeros_like(r),
                       jnp.where(act, -r, 0.0), nu1, nu2, coarse_iters,
                       alpha, smoother, kernels)

    b = jnp.where(act, -(_neighbor_sum(spec_l, S0) + spec.w0 * S0
                         + spec.g), 0.0)
    # `max_cycles` bounds the Krylov ITERATION budget here (each iteration
    # costs ~2 V-cycles); checked in chunks of `inner` iterations.  Krylov
    # L-inf residuals bounce around a decreasing trend, so the stall rule
    # watches the BEST iterate seen, keeps it, and only gives up after 4
    # consecutive chunks without a 5% new best.
    inner = 8
    n_chunks = max(1, -(-int(max_cycles) // inner))

    def cond(c):
        e, e_best, best, k, stall = c
        return jnp.logical_and(k < n_chunks * inner,
                               jnp.logical_and(best >= tol, stall < 4))

    def body(c):
        e, e_best, best, k, stall = c
        e_new, _ = bicgstab(matvec, b, x0=e, M=precond, tol=0.0,
                            maxiter=inner)
        # guard against Krylov breakdown producing nan: fall back to the
        # previous iterate and let the stall counter end the solve
        bad = ~jnp.isfinite(jnp.max(jnp.abs(e_new)))
        e_new = jnp.where(bad, e, e_new)
        new_res = jnp.max(jnp.abs(matvec(e_new) - b)) / g_scale
        improved = new_res <= 0.95 * best
        stall = jnp.where(improved, 0, stall + 1)
        e_best = jnp.where(new_res < best, e_new, e_best)
        best = jnp.minimum(best, new_res)
        return (e_new, e_best, best, k + inner, stall)

    # seed `best` with S0's own residual (e = 0), not inf: members that
    # already satisfy the tolerance (e.g. the converged majority of a
    # batched auto rescue, solve_mg) then skip the loop entirely instead
    # of burning a free 8-iteration BiCGStab chunk each
    res0 = (jnp.max(jnp.abs(b)) / g_scale).astype(S0.dtype)
    e0 = jnp.zeros_like(S0)
    _, e, res, k, _ = jax.lax.while_loop(
        cond, body, (e0, e0, res0, jnp.asarray(0), jnp.asarray(0)))
    # report V-cycle-equivalents (2 per iteration: the preconditioner pair)
    return S0 + jnp.where(act, e, 0.0), 2 * k, res


def _fmg_init(levels, spec, S0, nu1, nu2, coarse_iters, alpha, smoother,
              kernels):
    """Full-multigrid (nested-iteration) initial guess.

    The original equation's forcing restricts down the hierarchy (the
    folded g carries the level's dx^2, so each coarsening multiplies by 4
    — 16 for the biharmonic family), the coarsest level is smoothed to
    convergence, and the solution prolongs up with one V-cycle per level.
    The returned state replaces S0 on active cells (Dirichlet/icbc data on
    inactive cells rides through), warm-starting the main V-cycle loop —
    nested iteration starts the loop O(discretisation error) from the
    solution instead of O(1)."""
    gs = [spec.g]
    for l in range(len(levels) - 1):
        lv, nxt = levels[l], levels[l + 1]
        scale = 16.0 if lv.spec.bih else 4.0
        gc = scale * restrict(gs[-1], lv.odd, lv.spec.bcs[-2:])
        gs.append(jnp.where(nxt.spec.active, gc, 0.0))
    e = jnp.zeros_like(levels[-1].spec.w0)
    e = _vcycle(levels, len(levels) - 1, e, gs[-1], nu1, nu2,
                coarse_iters, alpha, smoother, kernels)
    for l in range(len(levels) - 2, -1, -1):
        lv = levels[l]
        e = prolong(e, lv.spec.w0.shape[-2:], lv.odd, lv.spec.bcs[-2:])
        e = jnp.where(lv.spec.active, e, 0.0)
        e = _vcycle(levels, l, e, gs[l], nu1, nu2, coarse_iters, alpha,
                    smoother, kernels)
    return jnp.where(spec.active, e, S0)


@partial(jax.jit, static_argnames=("max_cycles", "nu1", "nu2",
                                   "coarse_iters", "alpha", "smoother",
                                   "kernels", "fmg"))
def _solve_mg_jit(levels, S0, g0, tol, max_cycles, nu1, nu2, coarse_iters,
                  alpha, smoother, kernels=False, fmg=False):
    spec = levels[0].spec
    if g0 is not None:
        spec = dataclasses.replace(spec, g=jnp.where(spec.active, g0, 0.0))
    if fmg and len(levels) > 1:
        S0 = _fmg_init(levels, spec, S0, nu1, nu2, coarse_iters, alpha,
                       smoother, kernels)
    # dtype-aware floor: 1e-300 flushes to 0 in f32 and an
    # all-zero forcing would then report res = 0/0 = nan
    g_scale = jnp.maximum(jnp.max(jnp.abs(spec.g)),
                          jnp.asarray(jnp.finfo(spec.g.dtype).tiny,
                                      spec.g.dtype))

    def cond(c):
        S, k, res, stall = c
        # stop on tolerance, cycle budget, or 2 consecutive non-improving
        # cycles (the residual floor is precision-limited: f32 cannot reach
        # f64-style tols; a single slow cycle must not end the solve)
        return jnp.logical_and(k < max_cycles,
                               jnp.logical_and(res >= tol, stall < 2))

    def body(c):
        S, k, res, stall = c
        S = _vcycle(levels, 0, S, spec.g, nu1, nu2, coarse_iters, alpha,
                    smoother, kernels)
        new_res = jnp.max(jnp.abs(_residual(spec, S))) / g_scale
        stall = jnp.where(new_res <= 0.9 * res, 0, stall + 1)
        return (S, k + 1, new_res, stall)

    big = jnp.asarray(jnp.inf, S0.dtype)
    S, k, res, _ = jax.lax.while_loop(
        cond, body, (S0, jnp.asarray(0), big, jnp.asarray(0)))
    return S, k, res


def solve_mg(levels: List[MGLevel], S0=None, tol: float = 1e-6,
             max_cycles: int = 50, nu1: int = 2, nu2: int = 2,
             coarse_iters: int = 60, alpha: Optional[float] = None,
             smoother: Optional[str] = None, g0=None,
             accel: Optional[str] = "auto", fmg: bool = False):
    """V-cycle to a RESIDUAL tolerance (relative to max |g|).

    Note the convergence criterion differs from the SOR driver's
    solution-change rule: multigrid makes the true residual cheap to track,
    so we use it directly.

    ``g0`` overrides the finest level's folded constant term (the
    ``-F*delx^2`` forcing), enabling BATCHED solves over a shared operator:
    when ``S0``/``g0`` carry a leading batch axis the V-cycle is vmapped
    over it (each batch member converges by its own residual test).  ``S0``
    doubles as the icbc warm start — inactive (masked/boundary) cells keep
    their initial values, so Dirichlet data rides in unchanged.

    ``accel``: ``None`` runs plain V-cycles; ``'bicgstab'`` runs the
    V-cycle-preconditioned Krylov solver (the robust choice for the
    advection-dominated general families, whose plain coarse-grid
    correction stalls); ``'auto'`` (default) runs plain V-cycles and, only
    if they end above ``tol``, continues Krylov-wrapped from the partial
    result.

    Returns ``(solution, cycles, res, converged)``; ``converged`` is False
    when the cycle budget or the stagnation guard ended the solve with
    ``res`` still above ``tol`` (any member, for batched solves).
    """
    spec = levels[0].spec
    nd = spec.ndim
    if smoother is None:
        # prefer the choice stamped at build time (keeps this function
        # trace-composable: no concrete pulls of traced planes); pyramids
        # assembled by hand fall back to selecting here, host-side
        smoother = getattr(levels[0], "smoother", None) or \
            _auto_smoother(spec)
    if alpha is None:
        # undamped correction gives the textbook ~6-cycle rate on fully
        # active domains; irregular masks need damping for stability
        alpha = 0.8 if levels[0].masked else 1.0
    if accel not in (None, "auto", "bicgstab"):
        raise ValueError(f"unknown accel {accel!r}")
    if S0 is None:
        S0 = jnp.zeros(spec.w0.shape[-nd:], spec.w0.dtype)
    S0 = jnp.asarray(S0)

    from .solver import _multi_device
    batched = S0.ndim > nd
    # fused-kernel smoothing (each level asks solver.choose_sweep): for
    # unbatched solves (the batched path vmaps the cycle) on operands
    # that live on one device (GSPMD-sharded pyramids keep the
    # partitionable XLA sweeps)
    use_kernels = not batched and not _multi_device(S0, levels[0].spec.w0)

    def run(krylov, S0_, g0_):
        fn = _solve_mg_krylov_jit if krylov else _solve_mg_jit
        return fn(tuple(levels), S0_, g0_, jnp.asarray(tol, S0.dtype),
                  max_cycles, nu1, nu2, coarse_iters, float(alpha),
                  str(smoother), kernels=use_kernels,
                  fmg=bool(fmg) and not krylov)

    if batched:
        S0 = S0.reshape((-1,) + S0.shape[-nd:])
        if g0 is None:
            raise ValueError("batched solve_mg needs a batched g0")
        g0 = jnp.asarray(g0).reshape((-1,) + S0.shape[1:])
        stages = (
            [(False, 0)] if accel is None else
            [(True, 0)] if accel == "bicgstab" else
            [(False, 0), (True, 1)])
        S, k_tot, res_f = S0, 0, float("inf")
        for krylov, rescue in stages:
            if rescue and res_f < tol:
                break
            S, k, res = jax.vmap(
                lambda s, g, kr=krylov: run(kr, s, g))(S, g0)
            k_tot += int(jnp.max(k))
            res_f = float(jnp.max(res))
        return S, k_tot, res_f, res_f < tol
    if g0 is not None:
        g0 = jnp.asarray(g0)
    S, k, res = run(accel == "bicgstab", S0, g0)
    k_tot, res_f = int(k), float(res)
    if accel == "auto" and res_f >= tol:
        S, k, res = run(True, S, g0)
        k_tot += int(k)
        res_f = float(res)
    return S, k_tot, res_f, res_f < tol
