# -*- coding: utf-8 -*-
"""Sharded 2-D solves on the 8-device virtual CPU mesh against the
single-device solve: the GSPMD-sharded drivers users reach through
``iParams['mesh']`` (parallel/mesh.solve_sharded, solve_fixed_sharded)
and the explicit ppermute executor (parallel/halo.solve_fixed_halo), over
row, column and 2-D meshes, batches, boundary combinations, the
biharmonic ring and row counts the mesh does not divide."""
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from __graft_entry__ import _poisson_problem
from xinvert_tpu.solver import _solve_fixed_xla, solve
from xinvert_tpu.parallel import (solve_fixed_sharded, solve_sharded,
                                  solve_fixed_halo)
from sharded_cases import (mesh, mesh_yx, mesh_byx, prob2d, prob_bih,
                           close)

EXECUTORS = ["gspmd", "halo"]


def _fixed(executor, spec, S0, om, n, m):
    if executor == "gspmd":
        return solve_fixed_sharded(spec, S0, n, mesh=m, omega=om)
    return solve_fixed_halo(spec, S0, om, n, mesh=m)


def _flagship(ny=128, nx=64, batch=0):
    spec, S0, grid = _poisson_problem(batch=batch, ny=ny, nx=nx,
                                      dtype=np.float64)
    return spec, S0, np.float64(grid.omega_opt)


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("n_iters", [1, 8, 9])
def test_fixed_rows_8dev(executor, n_iters):
    """Masked extend+periodic Poisson over 8 row blocks."""
    spec, S0, om = _flagship()
    m = mesh_byx(1, 8, 1) if executor == "gspmd" else mesh_yx(8, 1)
    close(_fixed(executor, spec, S0, om, n_iters, m),
          _solve_fixed_xla(spec, S0, om, n_iters))


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_fixed_device_counts(executor, ndev):
    spec, S0, om = _flagship(ny=64)
    m = mesh_byx(1, ndev, 1) if executor == "gspmd" else mesh_yx(ndev, 1)
    close(_fixed(executor, spec, S0, om, 6, m),
          _solve_fixed_xla(spec, S0, om, 6))


@pytest.mark.parametrize("executor", EXECUTORS)
def test_fixed_batched(executor):
    """Per-slice forcing; GSPMD splits the batch over 'batch', the halo
    executor keeps it whole on each row block."""
    spec, S0, om = _flagship(ny=64, batch=4)
    m = mesh_byx(2, 4, 1) if executor == "gspmd" else mesh_yx(4, 1)
    close(_fixed(executor, spec, S0, om, 6, m),
          _solve_fixed_xla(spec, S0, om, 6))


@pytest.mark.parametrize("executor", EXECUTORS)
def test_fixed_x_bcs(executor):
    spec, S0 = prob2d(64, 48, ("fixed", "fixed"))
    m = mesh_byx(1, 4, 1) if executor == "gspmd" else mesh_yx(4, 1)
    close(_fixed(executor, spec, S0, 1.5, 7, m),
          _solve_fixed_xla(spec, S0, 1.5, 7))


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("my,mx,bcs,cross", [
    (2, 4, ("extend", "periodic"), False),
    (4, 2, ("fixed", "fixed"), False),
    (1, 4, ("extend", "periodic"), False),
    (2, 4, ("fixed", "periodic"), True),    # cross terms across the seam
])
def test_fixed_2d_mesh(executor, my, mx, bcs, cross):
    spec, S0 = prob2d(64, 64, bcs, cross=cross)
    m = mesh_byx(1, my, mx) if executor == "gspmd" else mesh_yx(my, mx)
    close(_fixed(executor, spec, S0, 1.4, 9, m),
          _solve_fixed_xla(spec, S0, 1.4, 9))


@pytest.mark.parametrize("executor", EXECUTORS)
def test_fixed_2d_mesh_corner_clamps(executor):
    """Extend rows with fixed x: the corner clamps sit on the corner
    blocks of a (2, 4) mesh."""
    spec, S0 = prob2d(64, 64, ("extend", "fixed"))
    m = mesh_byx(1, 2, 4) if executor == "gspmd" else mesh_yx(2, 4)
    close(_fixed(executor, spec, S0, 1.4, 9, m),
          _solve_fixed_xla(spec, S0, 1.4, 9))


def test_fixed_3axis_mesh():
    spec, S0, om = _flagship(ny=64, nx=64, batch=2)
    close(solve_fixed_sharded(spec, S0, 7, mesh=mesh_byx(2, 2, 2), omega=om),
          _solve_fixed_xla(spec, S0, om, 7))


@pytest.mark.parametrize("ny,ndev,bcs", [
    (300, 4, ("extend", "periodic")),
    (300, 4, ("fixed", "periodic")),
    (330, 8, ("extend", "periodic")),
])
def test_rows_not_divisible(ny, ndev, bcs):
    """Rows the mesh does not divide stay whole on each device (the
    'y' split is dropped for that dim) and the solve is unchanged."""
    spec, S0 = prob2d(ny, 32, bcs)
    out = solve_fixed_sharded(spec, S0, 5, mesh=mesh_byx(1, ndev, 1),
                              omega=1.5)
    close(out, _solve_fixed_xla(spec, S0, 1.5, 5))


@pytest.mark.parametrize("executor", EXECUTORS)
@pytest.mark.parametrize("ndev,bcs,ny", [
    (4, ("fixed", "fixed"), 64),
    (4, ("extend", "periodic"), 64),     # two-ring extend rows
    (8, ("extend", "fixed"), 128),
])
def test_biharmonic_row_mesh(executor, ndev, bcs, ny):
    spec, S0 = prob_bih(ny, 32, bcs)
    m = mesh_byx(1, ndev, 1) if executor == "gspmd" else mesh_yx(ndev, 1)
    close(_fixed(executor, spec, S0, 1.0, 6, m),
          _solve_fixed_xla(spec, S0, 1.0, 6))


@pytest.mark.parametrize("bcs,shape,B", [
    (("fixed", "fixed"), (1, 2, 4), 0),
    (("fixed", "periodic"), (1, 2, 4), 0),
    (("fixed", "periodic"), (2, 2, 2), 2),
])
def test_biharmonic_xsplit(bcs, shape, B):
    spec, S0 = prob_bih(64, 64, bcs, B=B)
    out = solve_fixed_sharded(spec, S0, 6, mesh=mesh_byx(*shape), omega=1.0)
    close(out, _solve_fixed_xla(spec, S0, 1.0, 6))


# ---------------------------------------------------------------- checked

@pytest.mark.parametrize("N,ce", [(40, 8), (37, 8)])
def test_checked_at_cap(N, ce):
    """tol=0 runs exactly N sweeps, the remainder window included."""
    spec, S0, om = _flagship()
    res = solve_sharded(spec, S0, mesh=mesh_byx(1, 8, 1), omega=om, tol=0.0,
                        max_iters=N, check_every=ce)
    assert int(res.iters) == N and not bool(res.overflow)
    close(res.S, _solve_fixed_xla(spec, S0, om, N))


def test_checked_converges_like_host():
    spec, S0, om = _flagship(ny=64)
    host = solve(spec, S0, om, tol=1e-7, max_iters=4000, check_every=8)
    shrd = solve_sharded(spec, S0, mesh=mesh_byx(1, 4, 1), omega=om,
                         tol=1e-7, max_iters=4000, check_every=8)
    assert int(host.iters) < 4000
    assert abs(int(host.iters) - int(shrd.iters)) <= 8
    np.testing.assert_allclose(np.asarray(shrd.S), np.asarray(host.S),
                               rtol=1e-9, atol=1e-12)


def test_checked_batched_telemetry():
    """Per-element iters/rel telemetry survives the batch split, elements
    stopping at different windows."""
    spec, S0, om = _flagship(ny=64, batch=4)
    g = np.asarray(spec.g).copy()
    yy = np.sin(2 * np.pi * np.arange(g.shape[-2]) / g.shape[-2])
    g[1] = yy[:, None] * np.ones_like(g[1])
    g[3] = 0.0
    g[3, g.shape[-2] // 2, g.shape[-1] // 2] = 1.0
    spec = dataclasses.replace(spec, g=jnp.asarray(g))
    host = solve(spec, S0, om, tol=1e-6, max_iters=3000, check_every=8)
    shrd = solve_sharded(spec, S0, mesh=mesh_byx(2, 4, 1), omega=om,
                         tol=1e-6, max_iters=3000, check_every=8)
    assert shrd.iters.shape == host.iters.shape
    assert len(set(np.asarray(host.iters).tolist())) > 1
    assert np.all(np.abs(np.asarray(shrd.iters, np.int64)
                         - np.asarray(host.iters, np.int64)) <= 8)
    np.testing.assert_allclose(np.asarray(shrd.S), np.asarray(host.S),
                               rtol=1e-8, atol=1e-11)


def test_checked_2d_mesh():
    spec, S0 = prob2d(64, 64, ("extend", "periodic"))
    res = solve_sharded(spec, S0, mesh=mesh_byx(1, 2, 4), omega=1.5,
                        tol=0.0, max_iters=21, check_every=4)
    assert int(res.iters) == 21
    close(res.S, _solve_fixed_xla(spec, S0, 1.5, 21))


def test_residual_rule_sharded():
    spec, S0, om = _flagship(ny=64)
    host = solve(spec, S0, om, tol=1e-6, max_iters=3000, check_every=8,
                 tol_type="residual")
    shrd = solve_sharded(spec, S0, mesh=mesh_byx(1, 4, 1), omega=om,
                         tol=1e-6, max_iters=3000, check_every=8,
                         tol_type="residual")
    assert abs(int(host.iters) - int(shrd.iters)) <= 8
    np.testing.assert_allclose(np.asarray(shrd.S), np.asarray(host.S),
                               rtol=1e-8, atol=1e-11)


def test_uneven_batch_pads_to_mesh():
    """5 slices over a 'batch' axis of 4: padded with copies of the last
    slice, solved, and cut back; telemetry per original slice."""
    spec, S0, om = _flagship(ny=32, nx=48, batch=5)
    res = solve_sharded(spec, S0, mesh=mesh_byx(4, 1, 1), omega=om, tol=0.0,
                        max_iters=13, check_every=4)
    assert res.S.shape == S0.shape and res.iters.shape == (5,)
    assert np.all(np.asarray(res.iters) == 13)
    close(res.S, _solve_fixed_xla(spec, S0, om, 13))


@pytest.mark.parametrize("mesh_shape,batch", [((4, 1, 1), 5),
                                              ((1, 4, 1), 0)])
def test_mesh_iparam_api(mesh_shape, batch):
    """iParams['mesh'] routes invert_* through the GSPMD-sharded solve,
    matching the single-device inversion at the sweep cap; a partial
    ('y',) mesh lifts to ('batch', 'y', 'x')."""
    from xinvert_tpu import invert_Poisson
    from xinvert_tpu.field import Field
    ny, nx = 64, 48
    lat = np.linspace(-80, 80, ny)
    lon = np.linspace(0, 360 - 360 / nx, nx)
    rng = np.random.default_rng(3)
    shape = ((batch,) if batch else ()) + (ny, nx)
    dims = (("t",) if batch else ()) + ("lat", "lon")
    coords = {"lat": lat, "lon": lon}
    if batch:
        coords["t"] = np.arange(batch)
    F = Field(rng.normal(0, 1e-5, shape), dims, coords, name="vor")
    iP = {"BCs": ["extend", "periodic"], "undef": np.nan, "mxLoop": 60,
          "tolerance": 0.0, "printInfo": False}
    ref = invert_Poisson(F, dims=["lat", "lon"], iParams=iP)
    m = (mesh(mesh_shape, ("batch", "y", "x")) if batch
         else mesh((4,), ("y",)))
    got = invert_Poisson(F, dims=["lat", "lon"], iParams={**iP, "mesh": m})
    np.testing.assert_allclose(got.values, ref.values, rtol=1e-12,
                               atol=1e-12 * np.nanmax(np.abs(ref.values)))
