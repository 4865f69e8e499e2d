# -*- coding: utf-8 -*-
"""f64-class residual certification from pure f32 arithmetic: error-free
transformations (ops/compensated.py) and mixed-precision iterative
refinement (refine.solve_refined).

The reference is float64 end-to-end (numba kernels, goldens at 1e-16,
the reference's tests/test_Bretherton.py:41); the fast path is float32.
A single f32 state stalls at the relative-residual floor
eps*mean|w0*S|/mean|g| (~6e-5 on the 96x192 full-sphere Poisson below);
the double-float32 refined state certifies ~1e-8, cross-checked against
true f64 arithmetic (CPU).  chip_smoke.py runs the certification at
2048^2 on a GPU."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from xinvert_tpu.ops.compensated import (two_sum, two_prod,
                                         residual_norm_compensated)
from xinvert_tpu.refine import solve_refined
from xinvert_tpu.solver import solve, _residual_norm, _residual_scale


def test_eft_exact_vs_f64():
    """TwoSum / TwoProd are error-FREE: s + e reproduces the f64 value
    exactly (within the f32 exponent range where the products neither
    overflow nor go subnormal)."""
    rng = np.random.default_rng(0)
    a = (rng.normal(0, 1, 20000) * 10.0 **
         rng.integers(-8, 9, 20000)).astype(np.float32)
    b = (rng.normal(0, 1, 20000) * 10.0 **
         rng.integers(-8, 9, 20000)).astype(np.float32)
    s, e = jax.jit(two_sum)(jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(
        np.asarray(s, np.float64) + np.asarray(e, np.float64),
        a.astype(np.float64) + b.astype(np.float64))
    p, pe = jax.jit(two_prod)(jnp.asarray(a), jnp.asarray(b))
    assert np.array_equal(
        np.asarray(p, np.float64) + np.asarray(pe, np.float64),
        a.astype(np.float64) * b.astype(np.float64))


def _sphere_poisson(ny, nx):
    """Full-sphere lat-lon Poisson (extend, periodic) — the polar metric
    makes this the hard certification case."""
    from xinvert_tpu.grid import Grid
    from xinvert_tpu.models.problems import build_poisson
    from xinvert_tpu.models.params import default_mParams

    lat = np.linspace(-88.75, 88.75, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    grid = Grid.make(("lat", "lon"), (lat, lon), "lat-lon",
                     bcs=("extend", "periodic"))
    llat = np.deg2rad(lat)[:, None]
    llon = np.deg2rad(lon)[None, :]
    vor = np.sin(3 * llon) * np.cos(2 * llat) * 1e-5
    spec = build_poisson(jnp.asarray(vor), jnp.ones((ny, nx), bool), grid,
                         default_mParams)
    return spec, grid


def _cast(spec, dt):
    return dataclasses.replace(
        spec, w=spec.w.astype(dt), w0=spec.w0.astype(dt),
        g=spec.g.astype(dt), relax=spec.relax.astype(dt))


@pytest.fixture(scope="module")
def sphere96():
    spec, grid = _sphere_poisson(96, 192)
    spec32 = _cast(spec, jnp.float32)
    # the SAME operator in exact f64 (up-cast is exact): the ground truth
    spec64 = _cast(spec32, jnp.float64)
    return spec32, spec64, grid


def test_compensated_norm_matches_f64_truth(sphere96):
    """The compensated f32 residual norm of an f32 state equals the f64
    evaluation of the same operator/state (the measurement part of the
    f32 floor is gone)."""
    spec32, spec64, grid = sphere96
    r = solve(spec32, jnp.zeros(spec32.w0.shape, jnp.float32),
              grid.omega_opt, tol=1e-9, max_iters=8000, check_every=32,
              tol_type="residual")
    comp = float(residual_norm_compensated(spec32, r.S)
                 / _residual_scale(spec32))
    truth = float(_residual_norm(spec64, r.S.astype(jnp.float64))
                  / _residual_scale(spec64))
    assert abs(comp - truth) <= 1e-3 * truth, (comp, truth)


def test_refined_certifies_below_f32_floor(sphere96):
    """solve_refined reaches a certified relative residual ~1e-7 where the
    single-f32 state stalls near its eps*mean|w0*S|/mean|g| floor, and the
    certificate agrees with true f64 arithmetic."""
    spec32, spec64, grid = sphere96
    S0 = jnp.zeros(spec32.w0.shape, jnp.float32)

    # single-f32 stall: a deep residual-rule solve cannot pass the floor
    stall = solve(spec32, S0, grid.omega_opt, tol=1e-9, max_iters=30000,
                  check_every=32, tol_type="residual")
    stall_rel = float(stall.rel_change)
    assert stall_rel > 1e-5, f"f32 floor unexpectedly low: {stall_rel:.2e}"

    res = solve_refined(spec32, S0, omega=grid.omega_opt, tol=1e-7,
                        max_rounds=5, inner_tol=1e-4, inner_iters=30000)
    rel = float(jnp.max(res.rel_residual))
    assert rel <= 1e-7, f"certification failed: {rel:.2e}"
    assert rel < stall_rel / 100.0

    # cross-check the certificate against true f64 arithmetic
    Sd = res.S_hi.astype(jnp.float64) + res.S_lo.astype(jnp.float64)
    truth = float(_residual_norm(spec64, Sd) / _residual_scale(spec64))
    assert abs(truth - rel) <= 0.05 * max(truth, rel), (rel, truth)


def test_refined_batched():
    """Batched refinement: per-slice certificates."""
    rng = np.random.default_rng(3)
    from xinvert_tpu import stencil
    ny, nx, B = 48, 64, 3
    A = (np.abs(rng.normal(1, 0.1, (ny, nx))) + 0.5).astype(np.float32)
    F = rng.normal(0, 1, (B, ny, nx)).astype(np.float32) * 1e-9
    spec = stencil.standard_2d(jnp.asarray(A), 0.0, jnp.asarray(A),
                               jnp.asarray(F), jnp.ones((ny, nx), bool),
                               (1.3e5, 1.0e5), ("fixed", "periodic"))
    assert spec.w0.dtype == jnp.float32
    res = solve_refined(spec, jnp.zeros((B, ny, nx), jnp.float32),
                        tol=1e-7, max_rounds=5, inner_tol=1e-4,
                        inner_iters=20000)
    assert res.rel_residual.shape == (B,)
    assert float(jnp.max(res.rel_residual)) <= 1e-7


def test_api_toltype_refined():
    """iParams tolType='refined' routes invert_* through solve_refined:
    certified relative residual <= tolerance, the (hi, lo) pair kept in
    models.api.LAST_REFINE."""
    from xinvert_tpu import invert_Poisson
    from xinvert_tpu.field import Field
    from xinvert_tpu.models import api as mapi

    ny, nx = 72, 144
    lat = np.linspace(-88.75, 88.75, ny)
    lon = np.linspace(0, 360 - 360 / nx, nx)
    llat = np.deg2rad(lat)[:, None]
    llon = np.deg2rad(lon)[None, :]
    # smooth zero-mean forcing (random noise is incompatible with the
    # extend+periodic operator's constant nullspace and pins the residual)
    vor = (np.sin(3 * llon) * np.cos(2 * llat) * 1e-5).astype(np.float32)
    F = Field(vor, ("lat", "lon"), {"lat": lat, "lon": lon}, name="vor")
    iP = {"BCs": ["extend", "periodic"], "undef": np.nan, "mxLoop": 20000,
          "tolerance": 1e-7, "printInfo": False, "tolType": "refined"}
    out = invert_Poisson(F, dims=["lat", "lon"], iParams=iP)
    assert out.shape == (ny, nx)
    assert np.isfinite(np.asarray(out)).all()
    assert float(np.max(np.asarray(mapi.LAST_SOLVE.rel_change))) <= 1e-7
    assert mapi.LAST_REFINE is not None
    assert mapi.LAST_REFINE.S_lo.shape == (ny, nx)


def test_api_mg_refined():
    """invert_*_mg with tolType='refined': MG-backed refinement (V-cycle
    correction solves via the g0 override) certifies the tolerance."""
    from xinvert_tpu import invert_Poisson_mg
    from xinvert_tpu.field import Field
    from xinvert_tpu.models import api as mapi

    ny, nx = 96, 192
    lat = np.linspace(-88.75, 88.75, ny)
    lon = np.linspace(0, 360 - 360 / nx, nx)
    llat, llon = np.deg2rad(lat)[:, None], np.deg2rad(lon)[None, :]
    vor = (np.sin(3 * llon) * np.cos(2 * llat) * 1e-5).astype(np.float32)
    F = Field(vor, ("lat", "lon"), {"lat": lat, "lon": lon}, name="vor")
    out = invert_Poisson_mg(
        F, dims=["lat", "lon"], tol=1e-9,
        iParams={"BCs": ["extend", "periodic"], "undef": np.nan,
                 "printInfo": False, "tolType": "refined"})
    assert np.isfinite(np.asarray(out)).all()
    r = mapi.LAST_REFINE
    assert float(np.max(np.asarray(r.rel_residual))) <= 1e-9
    assert float(np.max(np.asarray(mapi.LAST_SOLVE.rel_change))) <= 1e-9


def test_refined_3d():
    """Refinement is dimension-generic: a 3-D standard family certifies
    through the same EFT/correction machinery."""
    from xinvert_tpu import stencil
    rng = np.random.default_rng(11)
    sh = (12, 24, 32)
    A = ((np.abs(rng.normal(1.0, 0.1, sh)) + 0.5) * 2e-4).astype(np.float32)
    B = (np.abs(rng.normal(1.0, 0.1, sh)) + 0.5).astype(np.float32)
    F = rng.normal(0.0, 1e-9, sh).astype(np.float32)
    spec = stencil.standard_3d(jnp.asarray(A), jnp.asarray(B),
                               jnp.asarray(B), jnp.asarray(F),
                               jnp.ones(sh, bool), (5e3, 1.1e5, 1.0e5),
                               ("fixed", "extend", "periodic"))
    assert spec.w0.dtype == jnp.float32
    res = solve_refined(spec, jnp.zeros(sh, jnp.float32), tol=1e-7,
                        max_rounds=5, inner_tol=1e-4, inner_iters=20000)
    assert float(jnp.max(res.rel_residual)) <= 1e-7


def test_refined_sharded_mesh():
    """solve_refined(mesh=...): the default inner becomes the GSPMD
    sharded solve and the compensated residual passes run distributed —
    certified f64-class residuals AND multi-device in one call."""
    from xinvert_tpu import stencil
    from xinvert_tpu.parallel import make_grid_mesh
    rng = np.random.default_rng(3)
    ny, nx = 96, 128
    A = (np.abs(rng.normal(1, 0.1, (ny, nx))) + 0.5).astype(np.float32)
    F = (rng.normal(0, 1, (ny, nx)) * 1e-9).astype(np.float32)
    spec = stencil.standard_2d(jnp.asarray(A), 0.0, jnp.asarray(A),
                               jnp.asarray(F), np.ones((ny, nx), bool),
                               (1.3e5, 1.0e5), ("fixed", "periodic"))
    mesh = make_grid_mesh(8, batch=1)
    res = solve_refined(spec, jnp.zeros((ny, nx), jnp.float32), tol=1e-7,
                        max_rounds=5, inner_tol=1e-4, inner_iters=20000,
                        mesh=mesh)
    assert float(jnp.max(res.rel_residual)) <= 1e-7
    assert len(res.S_hi.sharding.device_set) == 8


def test_refined_mesh_fast_inner_routing(monkeypatch):
    """solve_refined(mesh=...) routes every inner correction solve through
    the GSPMD-sharded checked solve (parallel.mesh.solve_sharded), and
    each round still reduces the certified residual."""
    from xinvert_tpu import stencil, refine
    from xinvert_tpu.parallel import make_grid_mesh
    from xinvert_tpu.parallel import mesh as pmesh

    calls = {"n": 0}
    real = pmesh.solve_sharded

    def counting(*a, **k):
        calls["n"] += 1
        return real(*a, **k)

    monkeypatch.setattr(pmesh, "solve_sharded", counting)

    rng = np.random.default_rng(5)
    ny, nx = 256, 256
    A = (np.abs(rng.normal(1, 0.1, (ny, nx))) + 0.5).astype(np.float32)
    F = (rng.normal(0, 1, (ny, nx)) * 1e-9).astype(np.float32)
    spec = stencil.standard_2d(jnp.asarray(A), 0.0, jnp.asarray(A),
                               jnp.asarray(F), np.ones((ny, nx), bool),
                               (1.3e5, 1.0e5), ("fixed", "periodic"))
    mesh = make_grid_mesh(8, batch=1)
    S0 = jnp.zeros((ny, nx), jnp.float32)
    # small sweep budget: the point is the ROUTING and that refinement
    # still makes certified progress with change-rule inner solves
    res = refine.solve_refined(spec, S0, tol=1e-30, max_rounds=1,
                               inner_tol=1e-4, inner_iters=160, mesh=mesh)
    assert calls["n"] >= 2          # round-0 solve + 1 correction solve
    assert np.isfinite(float(jnp.max(res.rel_residual)))
    assert float(jnp.max(res.rel_residual)) < 1.0
