# -*- coding: utf-8 -*-
"""Universal stencil-program representation for elliptic SOR.

Every kernel family of the reference (/root/reference/xinvert/numbas.py:
invert_standard_{1D,2D,3D}, invert_standard_2D_test, invert_general_{2D,3D},
invert_general_bih_2D) shares one algebraic form once the per-point
coefficients are folded:

    residual(S) = sum_k  w_k * S[. + off_k]  +  w0 * S  +  g
    S          <- S + omega * residual(S) / (-w0)

with the SOR denominator equal to ``-w0`` in *all* seven families (verified
against the reference update formulas, e.g. numbas.py:351-369, :563-581,
:1132-1153, :1445-1479).  This module compiles each family's staggered
coefficient planes into a :class:`StencilSpec` — static neighbor offsets plus
dense precomputed weight planes — which a single vectorised red-black engine
(:mod:`xinvert_tpu.solver`) executes.  This replaces the reference's seven
hand-written lexicographic Gauss-Seidel kernels and their periodic/extend
boundary "stanza zoo": periodicity is folded into wrap-around neighbor access
and masks, so the interior update is uniform and data-parallel.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "StencilSpec",
    "standard_1d", "standard_2d", "standard_2d_e", "general_2d",
    "general_2d_bih", "standard_3d", "general_3d",
    "prune_zero_offsets",
]


def prune_zero_offsets(spec):
    """Drop offsets whose weight plane is identically zero (round 5).

    The biharmonic compiler (``general_2d_bih``) emits the full 16-offset
    stencil, but the flagship Munk/Stommel-Munk class (B = E = 0,
    numbas.py:1205 driven by apps.py:1793) zeroes the (+-2,+-2) cross and
    (+-1,+-1) planes — half the coefficient stream.  A sweep's memory
    traffic scales with the K+4 planes it streams, so pruning takes the
    Munk stream from 20 to 12 plane-equivalents (~1.6x).  Exact: a zero
    weight contributes ``0 * S == +-0`` to the neighbor accumulation, and
    removing it leaves every other term's order unchanged.

    Concrete (non-traced) weight stacks only — traced specs return
    unchanged.  The per-plane any() reductions run on-device and fetch as
    ONE K-bool transfer (not a host pull of the full stack); repeat calls
    on the SAME weight stack
    (dispatch gates + setup, refinement rounds re-wrapping g) hit an
    identity cache and pay no further sync.
    """
    if isinstance(spec.w, jax.core.Tracer) or len(spec.offsets) <= 1:
        return spec
    import weakref
    ent = _PRUNE_KEEP_CACHE.get(id(spec.w))
    if ent is not None and ent[0]() is spec.w:
        keep = ent[1]
    else:
        nz = np.asarray(jax.device_get(
            jnp.any(spec.w != 0, axis=tuple(range(1, spec.w.ndim)))))
        keep = None if nz.all() else (
            tuple(k for k in range(len(spec.offsets)) if nz[k]) or (0,))
        if len(_PRUNE_KEEP_CACHE) > 64:     # drop dead/stale entries
            _PRUNE_KEEP_CACHE.clear()
        try:
            _PRUNE_KEEP_CACHE[id(spec.w)] = (weakref.ref(spec.w), keep)
        except TypeError:                    # pragma: no cover
            pass                             # non-weakrefable array type
    if keep is None:
        return spec
    return dataclasses.replace(
        spec, w=spec.w[np.asarray(keep)],
        offsets=tuple(spec.offsets[k] for k in keep))


_PRUNE_KEEP_CACHE = {}


def _extend_foldable(spec) -> bool:
    """(extend, periodic) nearest-neighbor radius-1 specs can fold the
    extend-BC row copies into the weights (see _fold_extend)."""
    return (spec.bcs[-2] == "extend" and spec.bcs[-1] == "periodic"
            and not spec.bih
            and all(sum(1 for o in off if o != 0) == 1
                    and max(abs(o) for o in off) == 1
                    for off in spec.offsets))


def _fold_extend(spec):
    """Fold the extend pre-pass into the stencil: rows adjacent to the
    y boundary absorb their boundary-pointing weight into w0.

    With periodic x and no cross couplings, the extend copy makes
    S[0, i] == S[1, i] at the START of every iteration, and row 1's own
    value is unchanged within the half-sweep that reads it (red/black:
    a cell's neighbors are the opposite color, and w0 multiplies the
    cell's own pre-update value either way) — so reading S[0, i] is
    EXACTLY reading S[1, i], i.e. row 1's south weight belongs on its
    diagonal.  The boundary rows themselves are made inert (relax = 0)
    and the folded spec's bcs drop to ('fixed', 'periodic'): its fixed
    point is the extend problem's, with the boundary rows restored by one
    extend copy (ops/implicit.py differentiates through that form)."""
    offs = {tuple(o): i for i, o in enumerate(spec.offsets)}
    iS, iN = offs[(-1, 0)], offs[(1, 0)]
    w, w0, relax = spec.w, spec.w0, spec.relax
    w0 = w0.at[..., 1, :].add(w[iS][..., 1, :])
    w0 = w0.at[..., -2, :].add(w[iN][..., -2, :])
    w = w.at[iS, ..., 1, :].set(0.0)
    w = w.at[iN, ..., -2, :].set(0.0)
    relax = relax.at[..., 0, :].set(0.0)
    relax = relax.at[..., -1, :].set(0.0)
    return dataclasses.replace(spec, w=w, w0=w0, relax=relax,
                               bcs=spec.bcs[:-2] + ("fixed", spec.bcs[-1]))


@partial(jax.tree_util.register_dataclass,
         data_fields=["w", "w0", "g", "relax", "active"],
         meta_fields=["offsets", "bcs", "bih", "stop_on_zero_norm"])
@dataclasses.dataclass(frozen=True)
class StencilSpec:
    """A compiled elliptic problem.

    Data (arrays over the core grid, possibly with leading batch dims):
      w      : (K, *grid) neighbor weights; zeroed at inactive points.
      w0     : (*grid) center weight (== minus the SOR denominator).
      g      : (*grid) constant term (forcing folded in), zeroed if inactive.
      relax  : (*grid) active/(-w0), zeroed at inactive points.  The engine
               multiplies by the scalar over-relaxation factor omega.
      active : (*grid) bool, True where the point is updated.

    Meta (static):
      offsets: K neighbor offsets, each a tuple of core-dim shifts.
      bcs    : per-core-dim boundary conditions ('fixed'/'extend'/'periodic').
      bih    : biharmonic (two-ring) problem — controls the extend pre-pass.
      stop_on_zero_norm: replicate the reference's ``norm == 0`` break, which
               exists in the standard 1D/2D kernels only (numbas.py:410,:623,
               :736 vs :206,:978,:1195,:1580).
    """

    w: jnp.ndarray
    w0: jnp.ndarray
    g: jnp.ndarray
    relax: jnp.ndarray
    active: jnp.ndarray
    offsets: Tuple[Tuple[int, ...], ...]
    bcs: Tuple[str, ...]
    bih: bool = False
    stop_on_zero_norm: bool = True

    @property
    def ndim(self) -> int:
        return len(self.bcs)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _shift(a, off_axis_pairs, ndim):
    """a[(..., j+dj, i+di)] via wrap-around roll on the core (trailing) axes."""
    shifts = tuple(-o for o, _ in off_axis_pairs)
    axes = tuple(ax for _, ax in off_axis_pairs)
    return jnp.roll(a, shift=shifts, axis=axes)


def shift_plane(a, off):
    """Shifted coefficient plane: result[x] = a[x + off] (wrap-around).

    The wrap only feeds points that are (a) periodic in x — where wrapping is
    exactly the reference's periodic stanza semantics — or (b) outside the
    update region, where the value is irrelevant and later zeroed.
    """
    nd = a.ndim
    pairs = [(o, ax - len(off)) for ax, o in enumerate(off) if o != 0]
    if not pairs:
        return a
    return _shift(a, pairs, nd)


def _interior_mask(shape, bcs, bih):
    """Boolean mask of points the SOR sweep updates.

    Replicates the reference loop ranges: all dims except the last update
    indices 1..n-2 (2..n-3 for biharmonic); the last dim additionally updates
    its edge columns when periodic (numbas.py:314,:343,:373 and :1345-1569).
    Note the reference honours 'periodic' only on the last dim and 'extend'
    only on the second-to-last (and 1D last) dim; other combinations act as
    'fixed'.  We replicate that faithfully.
    """
    nd = len(shape)
    ring = 2 if bih else 1
    masks = []
    for ax, (n, bc) in enumerate(zip(shape, bcs)):
        m = np.zeros(n, dtype=bool)
        if ax == nd - 1:  # x: periodic edges are updated
            m[ring:n - ring] = True
            if bc == "periodic":
                m[:ring] = True
                m[n - ring:] = True
        else:
            r = ring if ax == nd - 2 or nd == 1 else 1
            # (3D z uses ring=1 and never periodic — matches k in 1..zc-2)
            m[r:n - r] = True
        masks.append(m)
    out = masks[0]
    for m in masks[1:]:
        out = out[..., None] & m
    return out


def _finalize(weights, w0, g, Fdef, shape, bcs, bih, stop_on_zero_norm, dtype):
    """Assemble a StencilSpec from an offset->weight dict."""
    interior = jnp.asarray(_interior_mask(shape, bcs, bih))
    active = jnp.logical_and(interior, Fdef)
    offsets = tuple(weights.keys())
    w = jnp.stack([jnp.where(active, weights[o], 0).astype(dtype) for o in offsets])
    w0 = jnp.where(active, w0, 0).astype(dtype)
    g = jnp.where(active, g, 0).astype(dtype)
    relax = jnp.where(active, 1.0 / jnp.where(active, -w0, 1.0), 0.0).astype(dtype)
    return StencilSpec(w=w, w0=w0, g=g, relax=relax, active=active,
                       offsets=offsets, bcs=tuple(bcs), bih=bih,
                       stop_on_zero_norm=stop_on_zero_norm)


# ---------------------------------------------------------------------------
# family compilers.  All take dense jnp coefficient planes shaped like the
# core grid, a boolean Fdef mask (True where forcing defined), the grid
# deltas, and return a StencilSpec.
# ---------------------------------------------------------------------------

def standard_2d(A, B, C, F, Fdef, deltas, bcs, include_cross=None):
    r"""d/dy(A dS/dy + B dS/dx) + d/dx(B dS/dy + C dS/dx) = F.

    Coefficients staggered as in the reference (numbas.py:216-416): A at
    half-grid in y (A[j] sits between j-1 and j), C at half-grid in x.
    """
    dely, delx = deltas
    ratio = delx / dely
    rsq = ratio ** 2
    rq = ratio / 4.0
    dxsq = delx ** 2
    dtype = jnp.result_type(A, C, F)

    Ajp = shift_plane(A, (1, 0))
    Cip = shift_plane(C, (0, 1))
    weights = {
        (1, 0): Ajp * rsq,
        (-1, 0): A * rsq,
        (0, 1): Cip,
        (0, -1): C,
    }
    if include_cross is None:
        include_cross = bool(np.any(np.asarray(B) != 0))
    if include_cross:
        Bjp = shift_plane(B, (1, 0))
        Bjm = shift_plane(B, (-1, 0))
        Bip = shift_plane(B, (0, 1))
        Bim = shift_plane(B, (0, -1))
        weights[(1, 1)] = (Bjp + Bip) * rq
        weights[(1, -1)] = -(Bjp + Bim) * rq
        weights[(-1, 1)] = -(Bjm + Bip) * rq
        weights[(-1, -1)] = (Bjm + Bim) * rq
    w0 = -(Ajp + A) * rsq - (Cip + C)
    g = -F * dxsq
    return _finalize(weights, w0, g, Fdef, F.shape[-2:], bcs, False, True, dtype)


def standard_2d_e(A, B, C, D, E, F, Fdef, deltas, bcs):
    r"""d/dy(A dS/dy + B dS/dx) + d/dx(C dS/dy + D dS/dx) + E S = F.

    The reference's invert_standard_2D_test (numbas.py:421-629): separate
    cross coefficients B (y-staggered) and C (x-staggered) plus a linear term
    E that also enters the denominator.
    """
    dely, delx = deltas
    ratio = delx / dely
    rsq = ratio ** 2
    rq = ratio / 4.0
    dxsq = delx ** 2
    dtype = jnp.result_type(A, D, F)

    Ajp = shift_plane(A, (1, 0))
    Dip = shift_plane(D, (0, 1))
    Bjp = shift_plane(B, (1, 0))
    Bjm = shift_plane(B, (-1, 0))
    Cip = shift_plane(C, (0, 1))
    Cim = shift_plane(C, (0, -1))
    weights = {
        (1, 0): Ajp * rsq,
        (-1, 0): A * rsq,
        (0, 1): Dip,
        (0, -1): D,
        (1, 1): (Bjp + Cip) * rq,
        (1, -1): -(Bjp + Cim) * rq,
        (-1, 1): -(Bjm + Cip) * rq,
        (-1, -1): (Bjm + Cim) * rq,
    }
    w0 = -(Ajp + A) * rsq - (Dip + D) + E * dxsq
    g = -F * dxsq
    return _finalize(weights, w0, g, Fdef, F.shape[-2:], bcs, False, True, dtype)


def _upwind_terms(coef, s, scale):
    """First-order upwind split of a first-derivative term with coefficient
    ``coef`` (already sign-normalised by ``s``: the equation times s has
    non-negative diffusion).  Returns (w_plus, w_minus, w_center) folded
    weight contributions such that w_plus + w_minus + w_center == 0 and the
    center contribution strengthens the diagonal — the standard stabiliser
    for advection-dominated COARSE operators in multigrid hierarchies
    (coarse spacings raise the cell Peclet number until the centered
    stencil loses diagonal dominance and smoothing diverges)."""
    pos = jnp.where(s * coef > 0, coef, 0.0)
    neg = jnp.where(s * coef < 0, coef, 0.0)
    return pos * scale, -neg * scale, -s * jnp.abs(coef) * scale


def _upwind_on(upwind) -> bool:
    """True when ``upwind`` requests the upwinded discretisation: a nonzero
    scalar (+-1 global convention) or a per-cell sign plane (arrays are
    always 'on' — plain truthiness would raise on them)."""
    if upwind is None:
        return False
    if isinstance(upwind, (int, float)):
        return upwind != 0
    return True


def general_2d(A, B, C, D, E, F, G, Fdef, deltas, bcs, upwind=0.0):
    r"""A Syy + B Syx + C Sxx + D Sy + E Sx + F S = G  (numbas.py:988-1201).

    ``upwind`` (0 = centered first derivatives, reference parity) selects
    first-order upwinding of the D/E advection terms with sign
    normalisation ``upwind = +-1`` or a per-cell +-1 plane (the sign
    making the diffusion terms
    non-negative); used for multigrid COARSE operators, where doubled
    spacings push the cell Peclet number past centered-difference
    stability.
    """
    dely, delx = deltas
    ratio = delx / dely
    rsq = ratio ** 2
    rq = ratio / 4.0
    dxsq = delx ** 2
    half = delx / 2.0
    dtype = jnp.result_type(A, C, G)

    w0 = -2.0 * (A * rsq + C) + F * dxsq
    if _upwind_on(upwind):
        dyp, dym, dy0 = _upwind_terms(D, upwind, ratio * delx)
        exp, exm, ex0 = _upwind_terms(E, upwind, delx)
        weights = {
            (1, 0): A * rsq + dyp,
            (-1, 0): A * rsq + dym,
            (0, 1): C + exp,
            (0, -1): C + exm,
        }
        w0 = w0 + dy0 + ex0
    else:
        weights = {
            (1, 0): A * rsq + D * ratio * half,
            (-1, 0): A * rsq - D * ratio * half,
            (0, 1): C + E * half,
            (0, -1): C - E * half,
        }
    weights.update({
        (1, 1): B * rq,
        (1, -1): -B * rq,
        (-1, 1): -B * rq,
        (-1, -1): B * rq,
    })
    g = -G * dxsq
    return _finalize(weights, w0, g, Fdef, G.shape[-2:], bcs, False, False, dtype)


def general_2d_bih(A, B, C, D, E, F, G, H, I, J, Fdef, deltas, bcs):
    r"""A Syyyy + B Syyxx + C Sxxxx + D Syy + E Syx + F Sxx + G Sy + H Sx
    + I S = J  — the 13/17-point biharmonic family (numbas.py:1205-1586).

    The reference updates with ``S -= omega * temp / denom``; negating all
    terms brings it to the universal ``denominator == -w0`` form.
    """
    dely, delx = deltas
    ratio = delx / dely
    rsq = ratio ** 2
    rq = ratio / 4.0
    rssr = ratio ** 4
    dxsq = delx ** 2
    dxtr = delx ** 3
    dxssr = delx ** 4
    dtype = jnp.result_type(A, C, J)

    n = {}  # neighbor coefficients of `temp` (to be negated)

    def add(off, val):
        n[off] = n.get(off, 0.0) + val

    # A d4/dy4 and C d4/dx4
    add((2, 0), A * rssr); add((1, 0), -4.0 * A * rssr)
    add((-1, 0), -4.0 * A * rssr); add((-2, 0), A * rssr)
    add((0, 2), C); add((0, 1), -4.0 * C)
    add((0, -1), -4.0 * C); add((0, -2), C)
    # B d4/dy2dx2 (coarse +-2 cross, /16)
    b = B * rsq / 16.0
    for sy in (2, -2):
        add((sy, 2), b); add((sy, 0), -2.0 * b); add((sy, -2), b)
    add((0, 2), -2.0 * b); add((0, -2), -2.0 * b)
    # D d2/dy2, F d2/dx2
    add((1, 0), D * rsq * dxsq); add((-1, 0), D * rsq * dxsq)
    add((0, 1), F * dxsq); add((0, -1), F * dxsq)
    # E d2/dydx
    e = E * rq * dxsq
    add((1, 1), e); add((-1, 1), -e); add((1, -1), -e); add((-1, -1), e)
    # G d/dy, H d/dx
    add((1, 0), G * dxtr * ratio / 2.0); add((-1, 0), -G * dxtr * ratio / 2.0)
    add((0, 1), H * dxtr / 2.0); add((0, -1), -H * dxtr / 2.0)

    center = (6.0 * (A * rssr + C) + B * rsq / 4.0
              - 2.0 * (D * rsq + F) * dxsq + I * dxssr)
    weights = {off: -val for off, val in n.items()}
    w0 = -center
    g = J * dxssr
    return _finalize(weights, w0, g, Fdef, J.shape[-2:], bcs, True, False, dtype)


def standard_3d(A, B, C, F, Fdef, deltas, bcs):
    r"""d/dz(A Sz) + d/dy(B Sy) + d/dx(C Sx) = F  (numbas.py:16-212).

    A staggered half-grid in z, B in y, C in x.  BCz is accepted but unused in
    the reference kernel body (z boundaries act fixed) — replicated here.
    """
    delz, dely, delx = deltas
    r2sq = (delx / delz) ** 2
    r1sq = (delx / dely) ** 2
    dxsq = delx ** 2
    dtype = jnp.result_type(A, C, F)

    Akp = shift_plane(A, (1, 0, 0))
    Bjp = shift_plane(B, (0, 1, 0))
    Cip = shift_plane(C, (0, 0, 1))
    weights = {
        (1, 0, 0): Akp * r2sq,
        (-1, 0, 0): A * r2sq,
        (0, 1, 0): Bjp * r1sq,
        (0, -1, 0): B * r1sq,
        (0, 0, 1): Cip,
        (0, 0, -1): C,
    }
    w0 = -(Akp + A) * r2sq - (Bjp + B) * r1sq - (Cip + C)
    g = -F * dxsq
    return _finalize(weights, w0, g, Fdef, F.shape[-3:], bcs, False, False, dtype)


def general_3d(A, B, C, D, E, F, G, H, Fdef, deltas, bcs,
               upwind=0.0):
    r"""A Szz + B Syy + C Sxx + D Sz + E Sy + F Sx + G S = H
    (numbas.py:746-984).  ``upwind`` as in :func:`general_2d`."""
    delz, dely, delx = deltas
    r2 = delx / delz
    r1 = delx / dely
    r2sq = r2 ** 2
    r1sq = r1 ** 2
    dxsq = delx ** 2
    half = delx / 2.0
    dtype = jnp.result_type(A, C, H)

    w0 = -2.0 * (A * r2sq + B * r1sq + C) + G * dxsq
    if _upwind_on(upwind):
        dzp, dzm, dz0 = _upwind_terms(D, upwind, r2 * delx)
        dyp, dym, dy0 = _upwind_terms(E, upwind, r1 * delx)
        dxp, dxm, dx0 = _upwind_terms(F, upwind, delx)
        weights = {
            (1, 0, 0): A * r2sq + dzp,
            (-1, 0, 0): A * r2sq + dzm,
            (0, 1, 0): B * r1sq + dyp,
            (0, -1, 0): B * r1sq + dym,
            (0, 0, 1): C + dxp,
            (0, 0, -1): C + dxm,
        }
        w0 = w0 + dz0 + dy0 + dx0
    else:
        weights = {
            (1, 0, 0): A * r2sq + D * r2 * half,
            (-1, 0, 0): A * r2sq - D * r2 * half,
            (0, 1, 0): B * r1sq + E * r1 * half,
            (0, -1, 0): B * r1sq - E * r1 * half,
            (0, 0, 1): C + F * half,
            (0, 0, -1): C - F * half,
        }
    g = -H * dxsq
    return _finalize(weights, w0, g, Fdef, H.shape[-3:], bcs, False, False, dtype)


def standard_1d(A, B, F, Fdef, deltas, bcs):
    r"""d/dx(A Sx) + B S = F  (numbas.py:633-742)."""
    (delx,) = deltas
    dxsq = delx ** 2
    dtype = jnp.result_type(A, F)
    Aip = shift_plane(A, (1,))
    weights = {
        (1,): Aip / dxsq,
        (-1,): A / dxsq,
    }
    w0 = -(Aip + A) / dxsq + B
    g = -F
    return _finalize(weights, w0, g, Fdef, F.shape[-1:], bcs, False, True, dtype)
