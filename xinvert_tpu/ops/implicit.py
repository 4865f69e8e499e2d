# -*- coding: utf-8 -*-
"""Differentiable inversions: implicit differentiation through the SOR
solve (a capability with no reference analog —
gradients of an inverted field enable sensitivity analysis, data
assimilation and parameter estimation around any ``invert_*`` physics).

The solved system is linear in the state: the folded stencil equation is

    R_i(S) = sum_o w_o(i) S(i+o) + w0(i) S(i) + g(i) = 0   (active i),
    S(j) = S0(j)                                           (pinned j),

i.e. ``M_aa S_a = -(g_a + M_ap S0_p)``.  By the implicit function
theorem the VJP needs ONE adjoint solve with the TRANSPOSE operator:

    lambda = M_aa^{-T} cot_a,
    g_bar      = -lambda
    w_o_bar(i) = -lambda(i) * S(i+o)
    w0_bar(i)  = -lambda(i) * S(i)
    S0_bar(j)  = cot_j - sum_{i,o: i+o=j} lambda(i) w_o(i)   (pinned j)

and the transpose operator is itself a stencil on the same grid:
``M^T``'s weight for offset ``o`` at cell ``i`` is ``w_{-o}(i+o)`` —
plane rolls of the flipped-offset weights (:func:`transpose_spec`) — so
the adjoint solve runs on the SAME engine (red-black SOR, the fused
sweep kernel, multigrid, a mesh...) at the same speed as the forward solve.

Accuracy: gradients are exact for the exactly-solved system; with
iterative solves the error is O(forward tol + adjoint tol).  Pinned
(inactive/boundary) cells hold constants from ``S0``, and their
cotangent correctly includes both the pass-through identity and the
influence of the pinned values on the active solution.

The primal runs the stock checked solve, so everything the engine
offers (kernels, check cadence, schemes) applies; the custom VJP means
``jax.grad`` never differentiates through the iteration itself (no
O(iters) memory, no blow-up through ``lax.while_loop``).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..stencil import StencilSpec

__all__ = ["transpose_spec", "solve_implicit"]


def transpose_spec(spec: StencilSpec) -> StencilSpec:
    """The adjoint operator's stencil: same grid, same active set and
    diagonal, weights ``w^T_o = roll(w_{-o}, -o)`` (M^T[i, i+o] =
    M[i+o, i] = w_{-o}(i+o)).  Offsets of the reference families come in
    +-o pairs, so the offset list is unchanged."""
    nd = spec.ndim
    idx = {off: k for k, off in enumerate(spec.offsets)}
    new_w = []
    for off in spec.offsets:
        neg = tuple(-o for o in off)
        if neg in idx:
            src = spec.w[idx[neg]]
        else:                                # pragma: no cover - unused
            src = jnp.zeros_like(spec.w[0])
        shifts = tuple(-o for o in off if o != 0)
        axes = tuple(ax - nd for ax, o in enumerate(off) if o != 0)
        new_w.append(jnp.roll(src, shifts, axes) if shifts else src)
    return dataclasses.replace(spec, w=jnp.stack(new_w))


def _sum_to(x, shape):
    """Reduce a full-shape cotangent to a (possibly broadcast) input
    shape — the standard broadcast-transpose."""
    x = jnp.asarray(x)
    if tuple(x.shape) == tuple(shape):
        return x
    extra = x.ndim - len(shape)
    if extra > 0:
        x = jnp.sum(x, axis=tuple(range(extra)))
    axes = tuple(i for i, (a, b) in enumerate(zip(x.shape, shape))
                 if b == 1 and a != 1)
    if axes:
        x = jnp.sum(x, axis=axes, keepdims=True)
    return x.reshape(shape)


def solve_implicit(spec: StencilSpec, S0, omega=None, tol: float = 1e-10,
                   max_iters: int = 20000, check_every: int = 32,
                   adjoint_tol=None, adjoint_iters=None,
                   **solve_kw):
    """Solve the stencil system, DIFFERENTIABLY in ``spec.w``,
    ``spec.w0``, ``spec.g`` and the pinned entries of ``S0``.

    Returns the solved state like ``solve(...).S``; under ``jax.grad`` /
    ``jax.vjp`` the backward pass runs one adjoint solve on the
    transpose stencil (:func:`transpose_spec`) with the same engine and
    (by default) the same tolerances.  Gradients w.r.t. physical
    parameters follow by chain rule when the coefficient builder runs
    inside the differentiated region.
    """
    from ..solver import solve
    from ..grid import optimal_omega

    if omega is None:
        omega = optimal_omega(jnp.shape(S0)[-spec.ndim:])
    if any(bc == "extend" for bc in spec.bcs):
        # extend boundaries are NOT pinned constants — they track the
        # interior — so the plain implicit formulation is wrong for them.
        # The (extend, periodic) radius-1 no-cross class (the flagship
        # global Poisson family) folds the copy into the stencil
        # (stencil._fold_extend): boundary-adjacent rows
        # absorb their boundary weight, boundary rows become inert, and
        # the extension is re-applied as a plain differentiable jnp op —
        # the fixed point (and hence the gradient) is identical.
        from ..stencil import _extend_foldable, _fold_extend
        from ..solver import _apply_extend
        if spec.ndim == 2 and _extend_foldable(spec):
            fspec = _fold_extend(spec)
            S_int = solve_implicit(fspec, S0, omega=omega, tol=tol,
                                   max_iters=max_iters,
                                   check_every=check_every,
                                   adjoint_tol=adjoint_tol,
                                   adjoint_iters=adjoint_iters,
                                   **solve_kw)
            return _apply_extend(spec, S_int)
        raise NotImplementedError(
            "solve_implicit supports 'fixed'/'periodic' BCs exactly, and "
            "('extend', 'periodic') for radius-1 no-cross 2-D stencils "
            "via the extend fold; other extend combinations need the "
            "boundary-tracking operator folded in and are not "
            "implemented")
    adjoint_tol = tol if adjoint_tol is None else adjoint_tol
    adjoint_iters = max_iters if adjoint_iters is None else adjoint_iters
    # only STATIC spec fields may live in the closure (traced arrays
    # closed over a custom_vjp leak out of the forward trace); relax and
    # the active mask thread through as primal args with zero cotangents
    # — correct, since relax (= active/(-w0)) steers the ITERATION only
    # and the fixed point depends on (w, w0, g) alone
    meta = dataclasses.replace(spec, w=None, w0=None, g=None,
                               relax=None, active=None)

    @jax.custom_vjp
    def f(w, w0, g, relax, act_f, S0_):
        sp = dataclasses.replace(meta, w=w, w0=w0, g=g, relax=relax,
                                 active=act_f > 0.5)
        return solve(sp, S0_, omega=omega, tol=tol, max_iters=max_iters,
                     check_every=check_every, **solve_kw).S

    def fwd(w, w0, g, relax, act_f, S0_):
        S = f(w, w0, g, relax, act_f, S0_)
        return S, (w, w0, g, relax, act_f, S)

    def bwd(res, cot):
        w, w0, g, relax, act_f, S = res
        active = act_f > 0.5
        sp = dataclasses.replace(meta, w=w, w0=w0, g=g, relax=relax,
                                 active=active)
        spT = transpose_spec(sp)
        nd = sp.ndim
        cot_a = jnp.where(active, cot, 0.0)
        # engine solves M^T lam + g_T = 0  ->  lam = M^{-T} cot  needs
        # g_T = -cot (on active cells; lam pinned to 0 elsewhere)
        spT = dataclasses.replace(spT, g=-cot_a)
        lam = solve(spT, jnp.zeros_like(cot), omega=omega,
                    tol=adjoint_tol, max_iters=adjoint_iters,
                    check_every=check_every, **solve_kw).S
        lam = jnp.where(active, lam, 0.0)

        g_bar = _sum_to(-lam, jnp.shape(g))
        w0_bar = _sum_to(-lam * S, jnp.shape(w0))
        wb = []
        T = jnp.zeros(jnp.broadcast_shapes(jnp.shape(lam), jnp.shape(S)),
                      jnp.result_type(lam))
        for k, off in enumerate(sp.offsets):
            shifts = tuple(-o for o in off if o != 0)
            axes = tuple(ax - nd for ax, o in enumerate(off) if o != 0)
            S_off = jnp.roll(S, shifts, axes) if shifts else S
            wb.append(-lam * S_off)
            # accumulate sum_{i: i+o=j} lam(i) w_o(i) at j (shift by +o)
            lw = lam * w[k]
            fshifts = tuple(o for o in off if o != 0)
            T = T + (jnp.roll(lw, fshifts, axes) if shifts else lw)
        w_bar = jnp.stack([_sum_to(b, jnp.shape(w)[1:]) for b in wb])
        # pinned cells: pass-through cotangent + influence on the
        # active solution through the neighbor reads
        S0_bar = _sum_to(jnp.where(active, 0.0, cot - T), jnp.shape(S0))
        return (w_bar, w0_bar, g_bar, jnp.zeros_like(relax),
                jnp.zeros_like(act_f), S0_bar)

    f.defvjp(fwd, bwd)
    return f(spec.w, spec.w0, spec.g, spec.relax,
             spec.active.astype(spec.w0.dtype), jnp.asarray(S0))
