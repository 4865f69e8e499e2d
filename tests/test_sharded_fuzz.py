# -*- coding: utf-8 -*-
"""Randomised sharded solves: seeded shapes, boundary combinations,
masks, cross terms, batches and meshes; fixed-count and checked
(tol=0, both stopping rules) GSPMD-sharded solves and the ghost-zone
executor must reproduce the single-device sweep."""
import numpy as np
import pytest

from xinvert_tpu.solver import _solve_fixed_xla
from xinvert_tpu.parallel import (solve_fixed_sharded, solve_sharded,
                                  solve_fixed_halo)
from sharded_cases import mesh_yx, mesh_byx, prob2d, prob3d, close

_BCS2 = [("fixed", "fixed"), ("extend", "periodic"), ("extend", "fixed"),
         ("fixed", "periodic")]
_BCS3 = [("fixed", "fixed", "fixed"), ("fixed", "extend", "periodic"),
         ("fixed", "extend", "fixed"), ("fixed", "fixed", "periodic")]
_MESHES = [(1, 8, 1), (1, 4, 2), (1, 2, 4), (2, 2, 2), (2, 4, 1), (1, 1, 8)]


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_sharded_2d(seed):
    rng = np.random.default_rng(seed)
    b, my, mx = _MESHES[seed % len(_MESHES)]
    ny = my * int(rng.integers(4, 12))
    nx = mx * int(rng.integers(4, 12))
    B = b * int(rng.integers(1, 3)) if b > 1 else 0
    spec, S0 = prob2d(ny, nx, _BCS2[int(rng.integers(4))],
                      cross=bool(rng.integers(2)), mask=bool(rng.integers(2)),
                      B=B, rng=rng)
    n = int(rng.integers(1, 12))
    ref = _solve_fixed_xla(spec, S0, 1.5, n)
    close(solve_fixed_sharded(spec, S0, n, mesh=mesh_byx(b, my, mx),
                              omega=1.5), ref)
    if b == 1:
        close(solve_fixed_halo(spec, S0, 1.5, n, mesh=mesh_yx(my, mx),
                               k_sweeps=int(rng.integers(1, 3))), ref)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_sharded_3d(seed):
    rng = np.random.default_rng(10 + seed)
    b, my, mx = _MESHES[seed % len(_MESHES)]
    nz = int(rng.integers(3, 9))
    ny = my * int(rng.integers(5, 10))
    nx = mx * int(rng.integers(5, 10))
    B = b * 2 if b > 1 else 0
    spec, S0 = prob3d(nz, ny, nx, _BCS3[int(rng.integers(4))], B=B,
                      seed=seed, mask=bool(rng.integers(2)))
    n = int(rng.integers(1, 10))
    ref = _solve_fixed_xla(spec, S0, 1.2, n)
    close(solve_fixed_sharded(spec, S0, n, mesh=mesh_byx(b, my, mx),
                              omega=1.2), ref)
    if b == 1:
        close(solve_fixed_halo(spec, S0, 1.2, n, mesh=mesh_yx(my, mx),
                               k_sweeps=2), ref)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_checked_sharded_3d(seed):
    rng = np.random.default_rng(20 + seed)
    b, my, mx = _MESHES[(2 + seed) % len(_MESHES)]
    spec, S0 = prob3d(int(rng.integers(3, 8)), my * 6, mx * 6,
                      _BCS3[seed % 4], B=2 * b if b > 1 else 0, seed=seed)
    n = int(rng.integers(5, 30))
    ce = int(rng.integers(1, 9))
    res = solve_sharded(spec, S0, mesh=mesh_byx(b, my, mx), omega=1.2,
                        tol=0.0, max_iters=n, check_every=ce)
    assert np.all(np.asarray(res.iters) == n)
    close(res.S, _solve_fixed_xla(spec, S0, 1.2, n))


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_checked_sharded_2d(seed):
    rng = np.random.default_rng(30 + seed)
    b, my, mx = _MESHES[(seed + 1) % len(_MESHES)]
    spec, S0 = prob2d(my * 8, mx * 8, _BCS2[seed % 4], rng=rng,
                      cross=bool(seed % 2), B=2 * b if b > 1 else 0)
    n = int(rng.integers(5, 30))
    tol_type = ("change", "residual")[seed % 2]
    res = solve_sharded(spec, S0, mesh=mesh_byx(b, my, mx), omega=1.5,
                        tol=0.0, max_iters=n,
                        check_every=int(rng.integers(1, 9)),
                        tol_type=tol_type)
    assert np.all(np.asarray(res.iters) == n)
    close(res.S, _solve_fixed_xla(spec, S0, 1.5, n))
