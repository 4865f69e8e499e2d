# -*- coding: utf-8 -*-
"""Residual-based stopping rule (iParams tolType='residual').

The reference stops on relative change of the mean-|S| norm — a Cauchy
criterion that can fire while the equation is far from satisfied.  The
extension stops on the TRUE relative discrete residual
mean|r|/mean|g| over active cells (what multigrid monitors), certifying
the folded system is solved to the requested level.
"""
import numpy as np
import jax.numpy as jnp

from xinvert_tpu import stencil
from xinvert_tpu.grid import optimal_omega
from xinvert_tpu.solver import (_neighbor_sum, _residual_norm,
                                _residual_scale, solve)


def _poisson(ny=64, nx=80, seed=0, bcs=("fixed", "periodic"), mask=False):
    rng = np.random.default_rng(seed)
    F = rng.normal(0.0, 1.0, (ny, nx))
    F -= F.mean()
    act = np.ones((ny, nx), bool)
    if mask:
        act[20:30, 30:45] = False
    A = np.ones((ny, nx))
    spec = stencil.standard_2d(jnp.asarray(A), 0.0, jnp.asarray(A),
                               jnp.asarray(F), jnp.asarray(act),
                               (1.0e5, 1.0e5), bcs)
    return spec, jnp.zeros((ny, nx))


def _true_rel_residual(spec, S):
    r = np.where(np.asarray(spec.active),
                 np.asarray(_neighbor_sum(spec, jnp.asarray(S))
                            + spec.w0 * jnp.asarray(S)), 0.0)
    g = np.where(np.asarray(spec.active), np.asarray(spec.g), 0.0)
    n = max(int(np.asarray(spec.active).sum()), 1)
    return (np.abs(r).sum() / n) / max(np.abs(g).sum() / n, 1e-300)


def test_residual_rule_certifies_solution():
    """Stopping at tolType='residual' tol=1e-8 leaves a true relative
    residual at most 1e-8 (the change rule makes no such guarantee)."""
    spec, S0 = _poisson()
    om = optimal_omega(S0.shape)
    res = solve(spec, S0, omega=om, tol=1e-8, max_iters=60000,
                tol_type="residual", use_kernel=False)
    assert not bool(np.asarray(res.overflow).any())
    rr = _true_rel_residual(spec, res.S)
    assert rr <= 1e-8, rr
    assert np.isclose(float(res.rel_change), rr, rtol=1e-6)


def test_residual_rule_masked():
    spec, S0 = _poisson(mask=True, bcs=("extend", "periodic"))
    om = optimal_omega(S0.shape)
    res = solve(spec, S0, omega=om, tol=1e-7, max_iters=60000,
                tol_type="residual", use_kernel=False)
    assert _true_rel_residual(spec, res.S) <= 1e-7


def test_residual_rule_batched():
    spec, _ = _poisson(ny=32, nx=40, seed=2)
    S0 = jnp.zeros((3, 32, 40))
    om = optimal_omega((32, 40))
    res = solve(spec, S0, omega=om, tol=1e-8, max_iters=60000,
                tol_type="residual", use_kernel=False)
    assert res.iters.shape == (3,)
    for b in range(3):
        assert _true_rel_residual(spec, res.S[b]) <= 1e-8


def test_residual_vs_change_iterations():
    """The residual rule runs longer than the change rule at the same tol
    (it certifies a stronger property) but both reach the fixed point."""
    spec, S0 = _poisson(seed=5)
    om = optimal_omega(S0.shape)
    ch = solve(spec, S0, omega=om, tol=1e-9, max_iters=60000,
               use_kernel=False)
    rs = solve(spec, S0, omega=om, tol=1e-9, max_iters=60000,
               tol_type="residual", use_kernel=False)
    assert int(rs.iters) >= int(ch.iters)
    assert _true_rel_residual(spec, rs.S) <= 1e-9


def test_residual_helpers_zero_forcing():
    """All-zero forcing: the scale floors at dtype tiny, rel residual is 0
    from the zero initial state (no 0/0 NaN — the mg.py ADVICE class)."""
    spec, S0 = _poisson(seed=7)
    import dataclasses
    spec0 = dataclasses.replace(spec, g=jnp.zeros_like(spec.g))
    assert float(_residual_scale(spec0)) > 0
    assert float(_residual_norm(spec0, S0)) == 0.0
    res = solve(spec0, S0, tol=1e-10, max_iters=100, tol_type="residual",
                use_kernel=False)
    assert int(res.iters) <= 2 and np.asarray(res.S).max() == 0.0


def test_residual_rule_through_public_api():
    import xinvert_tpu as xv
    from xinvert_tpu import Field
    from xinvert_tpu.models import api
    ny, nx = 40, 60
    lat = np.linspace(-60.0, 60.0, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    F = np.random.default_rng(9).normal(0, 1e-9, (ny, nx))
    Ff = Field(F, ("lat", "lon"), {"lat": lat, "lon": lon})
    iP = {"BCs": ["fixed", "periodic"], "undef": np.nan, "mxLoop": 60000,
          "tolerance": 1e-8, "printInfo": False, "tolType": "residual"}
    out = xv.invert_Poisson(Ff, dims=["lat", "lon"], iParams=iP)
    r = api.LAST_SOLVE
    assert float(r.rel_change) <= 1e-8
    assert np.isfinite(np.asarray(out.values)).all()


def test_residual_rule_with_cheby_scheme():
    """Both extensions compose: Chebyshev factors with the
    residual stopping rule."""
    spec, S0 = _poisson(seed=11)
    om = optimal_omega(S0.shape)
    res = solve(spec, S0, omega=om, tol=1e-7, max_iters=60000,
                tol_type="residual", scheme="cheby")
    assert not bool(np.asarray(res.overflow).any())
    assert _true_rel_residual(spec, res.S) <= 1e-7
