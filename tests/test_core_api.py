# -*- coding: utf-8 -*-
"""Dispatch-level inv_* API (reference core.py exports): custom coefficients
straight to a stencil family, consistency with the application layer."""
import numpy as np

from xinvert_tpu import (Field, inv_standard2D, inv_general2D,
                         inv_standard1D, invert_Poisson)


def test_inv_standard2D_matches_invert_poisson(data_dir):
    from xinvert_tpu import open_dataset
    ds = open_dataset(f"{data_dir}/Helmholtz_atmos.nc")
    vor = ds.vor.isel(time=0)
    lat = vor.coords["lat"]

    iP = {"BCs": ["fixed", "periodic"], "mxLoop": 2000, "tolerance": 1e-11,
          "printInfo": False}

    # build the Poisson coefficients exactly as the app layer does
    latr = np.deg2rad(lat)
    latH = np.empty_like(latr)
    latH[0] = np.nan
    latH[1:] = 0.5 * (latr[1:] + latr[:-1])
    A = Field(np.cos(latH), ("lat",), {"lat": lat})
    C = Field(1.0 / np.cos(latr), ("lat",), {"lat": lat})
    cos = Field(np.cos(latr), ("lat",), {"lat": lat})

    via_core = inv_standard2D(A, 0.0, C, vor * cos, dims=["lat", "lon"],
                              coords="lat-lon", iParams=iP)
    via_app = invert_Poisson(vor, dims=["lat", "lon"], iParams=iP)

    scale = np.abs(via_app.values).max()
    # identical spec and omega; fp association differences shift the
    # stopping point by an iterate, bounded by the tolerance level
    assert np.abs(via_core.values - via_app.values).max() < 1e-6 * scale


def test_inv_standard1D_runs():
    x = np.linspace(0, 1e6, 101)
    F = Field(np.sin(2 * np.pi * x / 1e6) * 1e-9, ("x",), {"x": x})
    out = inv_standard1D(1.0, 0.0, F, dims=["x"], coords="cartesian",
                         iParams={"BCs": ["fixed"], "printInfo": False})
    assert out.shape == F.shape
    assert np.isfinite(out.values).all()


def test_inv_general2D_runs():
    y = np.linspace(0, 1e6, 41)
    x = np.linspace(0, 1e6, 51)
    rng = np.random.default_rng(0)
    G = Field(rng.normal(0, 1e-10, (41, 51)), ("y", "x"),
              {"y": y, "x": x})
    out = inv_general2D(1.0, 0.0, 1.0, 0.0, 0.0, -1e-12, G,
                        dims=["y", "x"], coords="cartesian",
                        iParams={"BCs": ["fixed", "fixed"],
                                 "printInfo": False})
    assert out.shape == G.shape
    assert np.isfinite(out.values).all()


def test_inv_standard1D_periodic():
    """1-D periodic ring (reference numbas.py:633 periodic stanzas)."""
    import jax.numpy as jnp
    from xinvert_tpu import stencil, solve
    from xinvert_tpu.solver import _neighbor_sum

    n = 64
    x = np.linspace(0, 2 * np.pi, n, endpoint=False)
    rng = np.random.default_rng(0)
    A = 1.0 + 0.1 * np.abs(rng.standard_normal(n))
    F = np.sin(3 * x) * 1e-9
    B = np.full(n, -1e-10)          # damping fixes the constant mode
    spec = stencil.standard_1d(jnp.asarray(A), jnp.asarray(B),
                               jnp.asarray(F), jnp.ones(n, bool),
                               (1.0e5,), ("periodic",))
    res = solve(spec, jnp.zeros(n), tol=1e-15, max_iters=30000)
    S = np.asarray(res.S)
    assert np.isfinite(S).all() and not bool(res.overflow)
    r = np.asarray(_neighbor_sum(spec, res.S) + spec.w0 * res.S)
    r = np.where(np.asarray(spec.active), r, 0.0)
    scale = max(np.abs(np.asarray(spec.g)).max(),
                np.abs(np.asarray(spec.w0 * res.S)).max())
    assert np.abs(r).max() < 1e-10 * scale


def test_inv_standard3D_default_bcs_error_message():
    """3-D families with the default 2-entry BCs raise a descriptive
    error, not Grid.make's confusing length mismatch."""
    import pytest
    from xinvert_tpu import inv_standard3D
    z = np.linspace(1e5, 1e4, 10)
    y = np.linspace(-40, 40, 17)
    x = np.linspace(0, 350, 36)
    F = Field(np.zeros((10, 17, 36)), ("lev", "lat", "lon"),
              {"lev": z, "lat": y, "lon": x})
    with pytest.raises(ValueError, match="BCs"):
        inv_standard3D(1.0, 1.0, 1.0, F, dims=["lev", "lat", "lon"])


def test_enable_compile_cache(tmp_path, monkeypatch):
    """The persistent-compile-cache helper: JAX_COMPILATION_CACHE_DIR
    when it is set (and no directory of its own), else a fixed directory
    at the root of the checkout."""
    import os
    import jax
    import xinvert_tpu as xv
    old = jax.config.jax_compilation_cache_dir
    old_min = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
        jax.config.update("jax_compilation_cache_dir", old)
        assert xv.enable_compile_cache(min_compile_secs=5.0) == \
            str(tmp_path / "jc")
        assert jax.config.jax_compilation_cache_dir == old
        assert jax.config.jax_persistent_cache_min_compile_time_secs == 5.0
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        p = xv.enable_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(xv.__file__)))
        assert p == os.path.join(root, ".jax_cache") and os.path.isdir(p)
        assert jax.config.jax_compilation_cache_dir == p
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          old_min)
