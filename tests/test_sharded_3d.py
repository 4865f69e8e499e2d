# -*- coding: utf-8 -*-
"""Sharded 3-D solves on the 8-device virtual CPU mesh against the
single-device solve: z stays whole on each device, rows and columns split
over ('y', 'x'), batches over 'batch'.  GSPMD-sharded drivers
(parallel/mesh.py) and the explicit ghost-zone executor
(parallel/halo.solve_fixed_halo, k sweeps per exchange)."""
import numpy as np
import pytest

from xinvert_tpu.solver import _solve_fixed_xla, solve
from xinvert_tpu.parallel import (solve_fixed_sharded, solve_sharded,
                                  solve_fixed_halo)
from sharded_cases import mesh, mesh_yx, mesh_byx, prob3d, close


@pytest.mark.parametrize("executor", ["gspmd", "halo"])
def test_omega_class_odd_blocks(executor):
    """72 rows over 8 devices: odd 9-row blocks, the red-black phase of
    each block set by its global offset."""
    spec, S0 = prob3d(9, 72, 48, ("fixed", "extend", "periodic"))
    for n in (1, 9):
        ref = _solve_fixed_xla(spec, S0, 1.2, n)
        if executor == "gspmd":
            out = solve_fixed_sharded(spec, S0, n, mesh=mesh_byx(1, 8, 1),
                                      omega=1.2)
        else:
            out = solve_fixed_halo(spec, S0, 1.2, n, mesh=mesh_yx(8, 1),
                                   k_sweeps=2)
        close(out, ref)


@pytest.mark.parametrize("executor", ["gspmd", "halo"])
@pytest.mark.parametrize("ndev,bcs", [
    (2, ("fixed", "fixed", "fixed")),
    (4, ("fixed", "extend", "periodic")),
    (1, ("fixed", "extend", "periodic")),
])
def test_device_counts_3d(executor, ndev, bcs):
    spec, S0 = prob3d(7, 32, 20, bcs)
    ref = _solve_fixed_xla(spec, S0, 1.2, 7)
    if executor == "gspmd":
        out = solve_fixed_sharded(spec, S0, 7, mesh=mesh_byx(1, ndev, 1),
                                  omega=1.2)
    else:
        out = solve_fixed_halo(spec, S0, 1.2, 7, mesh=mesh_yx(ndev, 1),
                               k_sweeps=3)
    close(out, ref)


def test_batched_mesh_3d():
    spec, S0 = prob3d(6, 24, 20, ("fixed", "extend", "periodic"), B=4)
    out = solve_fixed_sharded(spec, S0, 6, mesh=mesh_byx(2, 4, 1), omega=1.2)
    close(out, _solve_fixed_xla(spec, S0, 1.2, 6))


def test_general3d_family_sharded():
    spec, S0 = prob3d(6, 32, 24, ("fixed", "extend", "periodic"),
                      general=True)
    out = solve_fixed_sharded(spec, S0, 8, mesh=mesh_byx(1, 4, 2), omega=1.2)
    close(out, _solve_fixed_xla(spec, S0, 1.2, 8))


@pytest.mark.parametrize("bcs,shape,B", [
    (("fixed", "extend", "periodic"), (1, 2, 4), 0),
    (("fixed", "extend", "fixed"), (1, 2, 4), 0),      # corner clamps
    (("fixed", "fixed", "periodic"), (1, 1, 4), 0),    # x-only split
    (("fixed", "extend", "periodic"), (2, 2, 2), 2),
])
def test_xsplit_3d(bcs, shape, B):
    spec, S0 = prob3d(6, 32, 32, bcs, B=B)
    ref = _solve_fixed_xla(spec, S0, 1.2, 9)
    out = solve_fixed_sharded(spec, S0, 9, mesh=mesh_byx(*shape), omega=1.2)
    close(out, ref)
    res = solve_sharded(spec, S0, mesh=mesh_byx(*shape), omega=1.2, tol=0.0,
                        max_iters=9, check_every=4)
    assert np.all(np.asarray(res.iters) == 9)
    close(res.S, ref)


@pytest.mark.parametrize("N,ce", [(40, 8), (37, 8)])
def test_checked_3d_at_cap(N, ce):
    spec, S0 = prob3d(7, 32, 20, ("fixed", "extend", "periodic"))
    res = solve_sharded(spec, S0, mesh=mesh_byx(1, 4, 1), omega=1.2,
                        tol=0.0, max_iters=N, check_every=ce)
    assert int(res.iters) == N and not bool(res.overflow)
    close(res.S, _solve_fixed_xla(spec, S0, 1.2, N))


def test_checked_3d_converges_like_host():
    spec, S0 = prob3d(7, 32, 20, ("fixed", "extend", "periodic"))
    host = solve(spec, S0, 1.2, tol=1e-6, max_iters=3000, check_every=8)
    shrd = solve_sharded(spec, S0, mesh=mesh_byx(1, 4, 1), omega=1.2,
                         tol=1e-6, max_iters=3000, check_every=8)
    assert int(host.iters) < 3000
    assert abs(int(host.iters) - int(shrd.iters)) <= 8
    np.testing.assert_allclose(np.asarray(shrd.S), np.asarray(host.S),
                               rtol=1e-8, atol=1e-11)


def test_checked_3d_batched_telemetry():
    import dataclasses
    import jax.numpy as jnp
    spec, S0 = prob3d(6, 24, 20, ("fixed", "extend", "periodic"), B=4)
    g = np.asarray(spec.g).copy()
    g[1] *= 1e-3
    g[3] = 0.0
    g[3, 3, 12, 10] = 1.0
    spec = dataclasses.replace(spec, g=jnp.asarray(g))
    host = solve(spec, S0, 1.2, tol=1e-6, max_iters=2000, check_every=8)
    shrd = solve_sharded(spec, S0, mesh=mesh_byx(2, 4, 1), omega=1.2,
                         tol=1e-6, max_iters=2000, check_every=8)
    assert shrd.iters.shape == (4,)
    assert np.all(np.abs(np.asarray(shrd.iters, np.int64)
                         - np.asarray(host.iters, np.int64)) <= 8)
    np.testing.assert_allclose(np.asarray(shrd.S), np.asarray(host.S),
                               rtol=1e-8, atol=1e-11)


def test_checked_3d_api_routing():
    """invert_omega with iParams['mesh'] matches the single-device
    inversion at the sweep cap."""
    from xinvert_tpu import invert_omega
    from xinvert_tpu.field import Field
    nz, ny, nx = 7, 32, 24
    lev = np.linspace(100000, 10000, nz)
    lat = np.linspace(-80, 80, ny)
    lon = np.linspace(0, 360 - 360 / nx, nx)
    rng = np.random.default_rng(2)
    F = Field(rng.normal(0, 1e-15, (nz, ny, nx)), ("lev", "lat", "lon"),
              {"lev": lev, "lat": lat, "lon": lon})
    iP = {"BCs": ["fixed", "fixed", "periodic"], "mxLoop": 30,
          "tolerance": 0.0, "printInfo": False}
    ref = invert_omega(F, dims=["lev", "lat", "lon"], iParams=iP,
                       mParams={"N2": 2e-4})
    got = invert_omega(F, dims=["lev", "lat", "lon"],
                       iParams={**iP, "mesh": mesh((4,), ("y",))},
                       mParams={"N2": 2e-4})
    np.testing.assert_allclose(got.values, ref.values, rtol=1e-12,
                               atol=1e-12 * np.abs(ref.values).max())


def test_residual_rule_sharded_3d():
    spec, S0 = prob3d(7, 32, 20, ("fixed", "extend", "periodic"))
    kw = dict(tol=1e-5, max_iters=3000, check_every=8, tol_type="residual")
    host = solve(spec, S0, 1.2, **kw)
    shrd = solve_sharded(spec, S0, mesh=mesh_byx(1, 2, 2), omega=1.2, **kw)
    assert abs(int(host.iters) - int(shrd.iters)) <= 8
    np.testing.assert_allclose(np.asarray(shrd.S), np.asarray(host.S),
                               rtol=1e-8, atol=1e-11)


def test_uneven_batch_3d():
    spec, S0 = prob3d(5, 16, 12, ("fixed", "extend", "periodic"), B=3)
    res = solve_sharded(spec, S0, mesh=mesh_byx(2, 1, 1), omega=1.2,
                        tol=0.0, max_iters=9, check_every=4)
    assert res.S.shape == S0.shape and res.iters.shape == (3,)
    close(res.S, _solve_fixed_xla(spec, S0, 1.2, 9))
