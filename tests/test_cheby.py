# -*- coding: utf-8 -*-
"""Chebyshev-accelerated SOR (SURVEY 7.8's optional accelerator).

The cyclic Chebyshev semi-iterative factor sequence (Golub & Varga 1961)
replaces the constant over-relaxation factor: w(0)=1, w(1)=1/(1-rho2/2),
w(m+1)=1/(1-rho2*w(m)/4), applied per red/black half-sweep, with rho2
recovered from the grid-optimal omega.  Same fixed point and asymptotic
rate as omega_opt SOR; measured parity-class iterate counts (documented
honestly — multigrid is the actual accelerator in this framework).
"""
import numpy as np
import jax.numpy as jnp

from xinvert_tpu import stencil
from xinvert_tpu.grid import optimal_omega
from xinvert_tpu.solver import (rho2_from_omega, solve, solve_fixed,
                                solve_fixed_cheby)


def _poisson(ny=96, nx=128, seed=0, bcs=("fixed", "periodic")):
    rng = np.random.default_rng(seed)
    F = rng.normal(0.0, 1.0, (ny, nx))
    F -= F.mean()
    A = np.ones((ny, nx))
    spec = stencil.standard_2d(jnp.asarray(A), 0.0, jnp.asarray(A),
                               jnp.asarray(F), jnp.ones((ny, nx), bool),
                               (1.0e5, 1.0e5), bcs)
    return spec, jnp.zeros((ny, nx))


def test_rho2_roundtrip():
    for om in (1.2, 1.5, 1.8, 1.95):
        r2 = float(rho2_from_omega(om))
        assert 0.0 < r2 < 1.0
        # invert back: omega_opt = 2 / (1 + sqrt(1 - rho2))
        assert np.isclose(2.0 / (1.0 + np.sqrt(1.0 - r2)), om, rtol=1e-12)


def test_cheby_same_fixed_point():
    """At convergence the Chebyshev iterates agree with plain SOR."""
    spec, S0 = _poisson()
    om = optimal_omega(S0.shape)
    ref = solve(spec, S0, omega=om, tol=1e-13, max_iters=20000,
                use_kernel=False)
    che = solve(spec, S0, omega=om, tol=1e-13, max_iters=20000,
                scheme="cheby")
    scale = float(jnp.max(jnp.abs(ref.S)))
    assert not bool(che.overflow.any())
    np.testing.assert_allclose(np.asarray(che.S), np.asarray(ref.S),
                               atol=2e-7 * scale)


def test_cheby_parity_class_iterations():
    """Cyclic Chebyshev shares omega_opt SOR's asymptotic rate; measured
    iterate counts are parity-class (the honest claim — the ramp removes
    the theoretical m*rho^m transient factor but does not beat a
    well-tuned constant omega; multigrid is the actual accelerator).
    Guard: within 15% either way, converged, not diverged."""
    spec, S0 = _poisson(ny=128, nx=128, bcs=("fixed", "fixed"))
    om = optimal_omega(S0.shape)
    sor = solve(spec, S0, omega=om, tol=1e-10, max_iters=20000,
                use_kernel=False)
    che = solve(spec, S0, omega=om, tol=1e-10, max_iters=20000,
                scheme="cheby")
    it_sor, it_che = int(sor.iters), int(che.iters)
    assert not bool(che.overflow.any())
    assert float(che.rel_change) < 1e-10
    assert 0.85 * it_sor <= it_che <= 1.15 * it_sor, (it_che, it_sor)


def test_cheby_fixed_matches_checked_sequence():
    """solve_fixed_cheby(n) reproduces the checked driver's iterate at the
    same sweep count (checkEvery=1 keeps chunking out of the picture)."""
    spec, S0 = _poisson(ny=48, nx=64, seed=3)
    om = optimal_omega(S0.shape)
    n = 37
    fixed = solve_fixed_cheby(spec, S0, om, n)
    # drive the checked solver to exactly n sweeps via max_iters
    che = solve(spec, S0, omega=om, tol=0.0, max_iters=n, scheme="cheby")
    assert int(che.iters) == n
    np.testing.assert_array_equal(np.asarray(fixed), np.asarray(che.S))


def test_cheby_masked_and_extend():
    """Masked domain + extend BC: same fixed point as SOR."""
    spec_m, S0 = _poisson(ny=64, nx=80, seed=5, bcs=("extend", "periodic"))
    rng = np.random.default_rng(7)
    mask = np.ones((64, 80), bool)
    mask[20:30, 30:45] = False
    F = rng.normal(0.0, 1.0, (64, 80))
    A = np.ones((64, 80))
    spec = stencil.standard_2d(jnp.asarray(A), 0.0, jnp.asarray(A),
                               jnp.asarray(F), jnp.asarray(mask),
                               (1.0e5, 1.0e5), ("extend", "periodic"))
    om = optimal_omega(S0.shape)
    ref = solve(spec, S0, omega=om, tol=1e-13, max_iters=30000,
                use_kernel=False)
    che = solve(spec, S0, omega=om, tol=1e-13, max_iters=30000,
                scheme="cheby")
    scale = float(jnp.max(jnp.abs(ref.S)))
    np.testing.assert_allclose(np.asarray(che.S), np.asarray(ref.S),
                               atol=2e-7 * scale)


def test_cheby_through_public_api():
    """iParams['scheme']='cheby' flows through invert_Poisson."""
    import xinvert_tpu as xv
    from xinvert_tpu import Field
    ny, nx = 40, 60
    lat = np.linspace(-60.0, 60.0, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    F = np.random.default_rng(9).normal(0, 1e-9, (ny, nx))
    Ff = Field(F, ("lat", "lon"), {"lat": lat, "lon": lon})
    iP = {"BCs": ["fixed", "periodic"], "undef": np.nan, "mxLoop": 5000,
          "tolerance": 1e-11, "printInfo": False}
    ref = xv.invert_Poisson(Ff, dims=["lat", "lon"], iParams=iP)
    che = xv.invert_Poisson(Ff, dims=["lat", "lon"],
                            iParams=dict(iP, scheme="cheby"))
    scale = np.abs(np.asarray(ref.values)).max()
    np.testing.assert_allclose(np.asarray(che.values),
                               np.asarray(ref.values), atol=1e-6 * scale)
