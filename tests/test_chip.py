# -*- coding: utf-8 -*-
"""Tests that need an NVIDIA GPU (marker ``chip``): the fused CUDA sweep
kernel against the XLA sweep at real widths, the direct solver's residual
with its transforms at full float32 precision, and the error-free
transformations of the double-float32 refinement as the card's compiler
runs them.  They skip elsewhere (the ``gpu`` fixture decides); run them
with ``JAX_PLATFORMS=cuda python -m pytest -m chip tests/test_chip.py``.
"""
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

pytestmark = pytest.mark.chip


def _rel(a, b):
    return float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))


def _poisson(batch, ny, nx):
    from __graft_entry__ import _poisson_problem
    spec, S0, grid = _poisson_problem(batch=batch, ny=ny, nx=nx,
                                      dtype=np.float32)
    spec = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a,
        spec)
    return spec, S0, grid


@pytest.mark.parametrize("batch,ny,nx,n", [(0, 2048, 2048, 100),
                                           (8, 721, 1440, 60)])
def test_kernel_matches_xla_real_width(gpu, batch, ny, nx, n):
    """The kernel rounds as the XLA sweep does (no FMA contraction):
    identical to the last bit in every case measured on an H100; held to
    1e-6 relative here."""
    from xinvert_tpu.solver import choose_sweep, solve_fixed
    spec, S0, grid = _poisson(batch, ny, nx)
    assert choose_sweep(spec, S0).kernel == "cuda"
    out = solve_fixed(spec, S0, grid.omega_opt, n)
    ref = solve_fixed(spec, S0, grid.omega_opt, n, use_kernel=False)
    assert _rel(out, ref) <= 1e-6


@pytest.mark.parametrize("family", ["biharmonic", "cross"])
def test_kernel_stencil_families(gpu, family):
    """The 12-offset biharmonic stencil (radius 2, cross term E) and the
    8-offset cross-term standard family at 2048^2: the kernel's templated
    offset counts."""
    from xinvert_tpu import stencil
    from xinvert_tpu.solver import solve_fixed
    n = 2048
    rng = np.random.default_rng(0)
    Fdef = np.ones((n, n), bool)
    Fdef[n // 3:n // 2, n // 4:n // 2] = False
    A = (np.abs(rng.normal(1, .1, (n, n))) + .5).astype(np.float32)
    Z = np.zeros((n, n), np.float32)
    J = rng.normal(0, 1e-7, (n, n)).astype(np.float32)
    if family == "biharmonic":
        E = (rng.normal(0, .1, (n, n)) * 1e-3).astype(np.float32)
        spec = stencil.general_2d_bih(
            *(jnp.asarray(a) for a in (A * 5e3, Z, A * 5e3, -A * 1e-3, E,
                                       -A * 1e-3, Z, Z, Z, J)),
            jnp.asarray(Fdef), (5e4, 5e4), ("fixed", "fixed"))
        K, om = 12, 1.0
    else:
        B = rng.normal(0, .1, (n, n)).astype(np.float32)
        spec = stencil.standard_2d(jnp.asarray(A), jnp.asarray(B),
                                   jnp.asarray(A), jnp.asarray(J),
                                   jnp.asarray(Fdef), (1.1, 1.0),
                                   ("extend", "periodic"))
        K, om = 8, 1.5
    spec = stencil.prune_zero_offsets(spec)
    assert len(spec.offsets) == K
    S0 = jnp.zeros((n, n), jnp.float32)
    out = solve_fixed(spec, S0, om, 40)
    ref = solve_fixed(spec, S0, om, 40, use_kernel=False)
    assert _rel(out, ref) <= 1e-6


def test_checked_solve_kernel_vs_xla(gpu):
    """A checked solve through the kernel stops at the same sweep as the
    XLA one and returns the same state."""
    from xinvert_tpu.solver import solve
    spec, S0, grid = _poisson(3, 512, 1024)
    kw = dict(omega=grid.omega_opt, tol=1e-5, max_iters=3000, check_every=32)
    a = solve(spec, S0, **kw)
    b = solve(spec, S0, use_kernel=False, **kw)
    np.testing.assert_array_equal(np.asarray(a.iters), np.asarray(b.iters))
    assert _rel(a.S, b.S) <= 1e-6


def test_direct_residual_on_card(gpu):
    """scheme='direct' on a global Poisson (Dirichlet rows, periodic x)
    with rough forcing: the float64 solve's residual is at roundoff; the
    float32 solve's residual and its distance from the float64 solution
    stay at what f32 conditioning allows on the CPU (5.5e-5 and 4.5e-4 at
    this size; both grow with the operator's n^2 condition number)."""
    from xinvert_tpu.grid import Grid
    from xinvert_tpu.models import problems
    from xinvert_tpu.models.params import default_mParams
    from xinvert_tpu.solver import solve
    ny, nx = 256, 512
    lat = np.linspace(-90 + 90 / ny, 90 - 90 / ny, ny)
    lon = np.linspace(0, 360 - 360 / nx, nx)
    grid = Grid.make(("lat", "lon"), (lat, lon), "lat-lon",
                     ("fixed", "periodic"))
    rng = np.random.default_rng(0)
    vor = rng.normal(0, 1e-5, (ny, nx))
    spec = problems.build_poisson(jnp.asarray(vor), jnp.ones((ny, nx), bool),
                                  grid, default_mParams)
    spec64 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float64) if a.dtype == jnp.float32 else a,
        spec)
    spec32 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a,
        spec)
    r64 = solve(spec64, jnp.zeros((ny, nx), jnp.float64), scheme="direct")
    r32 = solve(spec32, jnp.zeros((ny, nx), jnp.float32), scheme="direct")
    assert r32.S.dtype == jnp.float32
    assert float(r64.rel_change) <= 1e-9
    assert float(r32.rel_change) <= 1e-4
    assert _rel(r32.S.astype(jnp.float64), r64.S) <= 1e-3


def test_eft_identities_on_card(gpu):
    """TwoSum and TwoProd are exact on the card: hi + lo equals the f64
    sum and product of the f32 inputs, bit for bit."""
    from xinvert_tpu.ops.compensated import two_sum, two_prod
    rng = np.random.default_rng(1)
    a = (rng.standard_normal(1 << 20) * 10.0 ** rng.integers(
        -6, 6, 1 << 20)).astype(np.float32)
    b = (rng.standard_normal(1 << 20) * 10.0 ** rng.integers(
        -6, 6, 1 << 20)).astype(np.float32)
    s, e = jax.jit(two_sum)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(s, np.float64) + np.asarray(e, np.float64),
        a.astype(np.float64) + b.astype(np.float64))
    p, q = jax.jit(two_prod)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(p, np.float64) + np.asarray(q, np.float64),
        a.astype(np.float64) * b.astype(np.float64))
