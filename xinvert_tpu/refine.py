# -*- coding: utf-8 -*-
"""Mixed-precision iterative refinement: f64-class certified residuals
from float32 arithmetic.

The reference runs float64 end-to-end (numba kernels, goldens asserted at
1e-16, e.g. the reference's tests/test_Bretherton.py:41); the fast path here
is float32.  A single f32 state cannot certify tight residuals: rounding the
exact solution to f32 already perturbs the per-cell residual by
~eps*|w0*S|, so the relative floor ``eps * mean|w0*S| / mean|g|`` (solve
docstring) is a STATE-precision limit, not just a measurement one — about
2.6e-3 at 512^2 and 1e-1 at 2048^2 on the full-sphere Poisson.

This module lifts both limits the classic mixed-precision way:

1. keep the state as an unevaluated double-float32 pair ``S = hi + lo``;
2. measure the TRUE residual of ``hi + lo`` with error-free transformations
   (:mod:`xinvert_tpu.ops.compensated` — O(eps^2) per-cell accuracy from
   pure f32 ops);
3. solve the CORRECTION system ``A e = -r`` entirely in fast f32 (the
   SOR engine with its fused sweep kernel, or multigrid — the correction
   only needs a few digits) and absorb ``e`` into the pair with a TwoSum
   renormalisation.

Each round multiplies the residual by ~the inner solve's reduction
factor, far past the single-f32 floor; the 96x192 CPU chain reaches
5.2e-9, validated against true f64 arithmetic (tests/test_refine.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import jax.numpy as jnp

import jax

from .ops.compensated import (two_sum, residual_compensated,
                              residual_norm_compensated)
from .solver import solve, _residual_scale
from .stencil import StencilSpec

__all__ = ["solve_refined", "RefineResult", "mg_inner"]


@jax.jit
def _correction_rhs(spec, S_hi, S_lo):
    """Masked compensated residual as the correction forcing (one jitted
    pass — the host refinement loop otherwise dispatches the EFT cascade
    eagerly, one op at a time)."""
    return jnp.where(spec.active,
                     residual_compensated(spec, S_hi, S_lo),
                     0.0).astype(S_hi.dtype)


@jax.jit
def _absorb(S_hi, S_lo, e):
    """(hi, lo) <- TwoSum(hi, lo + e): keeps hi correctly rounded."""
    return two_sum(S_hi, S_lo + e)


class RefineResult(NamedTuple):
    """``S = S_hi + S_lo`` (return ``S_hi + S_lo`` in f64 for full accuracy;
    ``S_hi`` alone is the correctly-rounded f32 solution)."""
    S_hi: jnp.ndarray
    S_lo: jnp.ndarray
    rel_residual: jnp.ndarray    # certified mean|r|/mean|g| per batch slice
    rounds: int                  # refinement rounds run

    @property
    def S(self):
        return self.S_hi


def _default_inner(spec: StencilSpec, omega, inner_tol: float,
                   inner_iters: int) -> Callable:
    """Correction solver: the stock checked SOR solve (the sweep
    ``solver.choose_sweep`` picks) with the solution-CHANGE rule at a
    tightened tolerance (``inner_tol * 1e-3``).

    The change rule costs one norm pass per check; the residual rule would
    re-evaluate the neighbour sum every check window.  Correction accuracy
    is uncritical (a cruder correction just means another refinement
    round) and certification is measured independently by the
    compensated residual pass."""
    tol = inner_tol * 1e-3

    def inner(cspec, S0):
        return solve(cspec, S0, omega=omega, tol=tol,
                     max_iters=inner_iters, check_every=32,
                     tol_type="change").S
    return inner


def mg_inner(levels, tol: float = 1e-4, max_cycles: int = 25, **kw):
    """An ``inner`` callable for :func:`solve_refined` backed by multigrid
    V-cycles on a prebuilt pyramid: each correction system rides the
    ``g0`` override of :func:`xinvert_tpu.mg.solve_mg` (the fine-level
    constant term is the current residual), so certified solves cost a
    few cycles per round instead of thousands of SOR sweeps."""
    from .mg import solve_mg

    def inner(cspec, S0):
        S, _, _, _ = solve_mg(levels, S0=S0, g0=cspec.g, tol=tol,
                              max_cycles=max_cycles, fmg=False, **kw)
        return S
    return inner


def _refine_rounds_impl(spec, S0, omega, tol, inner_tol_c, inner_iters,
                        max_rounds, check_every, kernel):
    """The whole refinement — round-0 solve plus (compensated residual →
    correction solve → TwoSum absorb) rounds — as ONE traced program: the
    correction rounds ride a single ``lax.while_loop`` whose body inlines
    the checked SOR solve (solver._solve_impl), so a refined solve costs
    one dispatch instead of per-round host syncs.

    Semantics match the host loop exactly: keep the best iterate, restore
    it and stop when a round doubles the best residual (nullspace drift),
    stop when the certified residual reaches ``tol`` or after
    ``max_rounds`` corrections."""
    from .solver import _solve_impl
    dtype = S0.dtype
    scale = _residual_scale(spec)
    tol = jnp.asarray(tol, dtype)

    def inner(g, S_init):
        cspec = dataclasses.replace(spec, g=g)
        return _solve_impl(cspec, S_init, jnp.asarray(omega, dtype),
                           jnp.asarray(inner_tol_c, dtype),
                           jnp.asarray(inner_iters, jnp.int32),
                           check_every=check_every, kernel=kernel,
                           scheme="sor", tol_type="change").S

    S_hi = inner(spec.g, S0)
    S_lo = jnp.zeros_like(S_hi)
    rel = residual_norm_compensated(spec, S_hi, S_lo) / scale
    c0 = dict(hi=S_hi, lo=S_lo, rel=rel, b_hi=S_hi, b_lo=S_lo, b_rel=rel,
              rounds=jnp.zeros((), jnp.int32),
              done=jnp.max(rel) <= tol)

    def cond(c):
        return (~c["done"]) & (c["rounds"] < max_rounds)

    def body(c):
        r = jnp.where(spec.active,
                      residual_compensated(spec, c["hi"], c["lo"]),
                      0.0).astype(dtype)
        e = inner(r, jnp.zeros_like(c["hi"]))
        hi, lo = two_sum(c["hi"], c["lo"] + e)
        rel = residual_norm_compensated(spec, hi, lo) / scale
        m, bm = jnp.max(rel), jnp.max(c["b_rel"])
        improved = m <= bm
        diverged = m > 2.0 * bm

        def sel(flag, a, b):
            return jax.tree_util.tree_map(
                lambda x, y: jnp.where(flag, x, y), a, b)

        b_hi, b_lo, b_rel = sel(improved, (hi, lo, rel),
                                (c["b_hi"], c["b_lo"], c["b_rel"]))
        hi, lo, rel = sel(diverged, (b_hi, b_lo, b_rel), (hi, lo, rel))
        return dict(hi=hi, lo=lo, rel=rel, b_hi=b_hi, b_lo=b_lo,
                    b_rel=b_rel, rounds=c["rounds"] + 1,
                    done=diverged | (jnp.max(rel) <= tol))

    out = jax.lax.while_loop(cond, body, c0)
    return out["hi"], out["lo"], out["rel"], out["rounds"]


_refine_jit = jax.jit(_refine_rounds_impl,
                      static_argnames=("check_every", "kernel"))


def solve_refined(spec: StencilSpec, S0, omega: Optional[float] = None,
                  tol: float = 1e-6, max_rounds: int = 8,
                  inner: Optional[Callable] = None,
                  inner_tol: float = 1e-4, inner_iters: int = 20000,
                  mesh=None) -> RefineResult:
    """Solve to a CERTIFIED relative residual ``tol`` in double-float32.

    ``inner(correction_spec, S0) -> S`` solves one correction system (the
    same operator with ``g`` replaced by the current residual); the default
    is the stock checked SOR solve with the solution-CHANGE rule at
    ``inner_tol * 1e-3`` (see :func:`_default_inner`; ``inner_tol``
    therefore tunes correction DEPTH, it does not bound any residual — the
    certificate below is measured independently).  Pass :func:`mg_inner`
    (or any closure) for V-cycle corrections.  ``mesh`` (a
    jax.sharding.Mesh) distributes the inner solves (the GSPMD-sharded
    checked solve) and the compensated residual passes run on the sharded
    state.

    The refinement loop runs on the host (a handful of rounds, each one
    inner solve + one compensated residual pass); certification reads the
    compensated norm, accurate to ~eps*log N of its own value.
    """
    S0 = jnp.asarray(S0)
    if omega is None:
        from .grid import optimal_omega
        omega = optimal_omega(S0.shape[-spec.ndim:])
    if inner is None and mesh is not None:
        from .parallel.mesh import solve_sharded, shard_problem
        spec, S0 = shard_problem(spec, S0, mesh)

        def inner(cspec, S0_):
            # the GSPMD-sharded checked solve, with the change rule at the
            # tightened tolerance like the local default inner: crude
            # corrections just mean another refinement round, and the
            # change norm costs one pass per check vs the residual rule's
            # full neighbor-sum re-evaluation
            return solve_sharded(cspec, S0_, mesh=mesh, omega=omega,
                                 tol=inner_tol * 1e-3,
                                 max_iters=inner_iters, check_every=32,
                                 tol_type="change").S
    if inner is None:
        # single-device default-inner path: the WHOLE refinement runs as
        # one jitted program (_refine_rounds_impl) — no per-round host
        # syncs.  The sweep choice happens here (host side, concrete
        # spec), in solver.choose_sweep like every other solve.
        from .solver import choose_sweep
        kernel = choose_sweep(spec, S0).kernel
        hi, lo, rel, rounds = _refine_jit(
            spec, S0, jnp.asarray(omega, S0.dtype), tol,
            inner_tol * 1e-3, inner_iters,
            jnp.asarray(max_rounds, jnp.int32),
            check_every=32, kernel=kernel)
        return RefineResult(S_hi=hi, S_lo=lo, rel_residual=rel,
                            rounds=int(rounds))

    scale = _residual_scale(spec)

    # round 0: the plain f32 solve
    S_hi = inner(spec, S0)
    S_lo = jnp.zeros_like(S_hi)
    rel = residual_norm_compensated(spec, S_hi, S_lo) / scale
    rounds = 0
    best = (S_hi, S_lo, rel)
    for rounds in range(1, max_rounds + 1):
        if float(jnp.max(rel)) <= tol:
            rounds -= 1
            break
        # correction system A e = -r: the engine solves
        # sum w e + w0 e + g_c = 0, so g_c = r (per-cell, compensated)
        r = _correction_rhs(spec, S_hi, S_lo)
        cspec = dataclasses.replace(spec, g=r)
        e = inner(cspec, jnp.zeros_like(S_hi))
        # absorb: (hi, lo) <- TwoSum(hi, lo + e) keeps hi correctly rounded
        S_hi, S_lo = _absorb(S_hi, S_lo, e)
        rel = residual_norm_compensated(spec, S_hi, S_lo) / scale
        if float(jnp.max(rel)) <= float(jnp.max(best[2])):
            best = (S_hi, S_lo, rel)
        elif float(jnp.max(rel)) > 2.0 * float(jnp.max(best[2])):
            # diverging corrections (e.g. nullspace drift): keep the best
            S_hi, S_lo, rel = best
            break
    return RefineResult(S_hi=S_hi, S_lo=S_lo, rel_residual=rel,
                        rounds=rounds)
