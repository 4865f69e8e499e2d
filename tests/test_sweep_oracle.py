# -*- coding: utf-8 -*-
"""The XLA red-black sweep (solver._sweep_with and the drivers around it)
against the numpy red-black oracle (tests/oracle.redblack_from_spec): the
2-D standard, general and biharmonic families and the 3-D families, with
every boundary combination, masks, batches and odd sizes.  3-D problems
always run the XLA sweep (solver.choose_sweep)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from xinvert_tpu import stencil, solver
from xinvert_tpu.solver import _solve_fixed_xla, solve
from oracle import redblack_from_spec, _extend_numpy


def _close(out, ref):
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-11,
                               atol=1e-11 * np.abs(ref).max())


def _standard2d(bcs, batch=0, seed=0, cross=False, shape=(14, 18),
                per_slice=False):
    rng = np.random.default_rng(seed)
    core = shape
    lead = batch if isinstance(batch, tuple) else ((batch,) if batch else ())
    cshape = lead + core if per_slice else core
    A = np.abs(rng.normal(1.0, 0.1, cshape)) + 0.5
    B = rng.normal(0.0, 0.05, cshape) if cross else np.zeros(cshape)
    C = np.abs(rng.normal(1.0, 0.1, cshape)) + 0.5
    F = rng.normal(0.0, 1.0, lead + core)
    Fdef = np.ones(core, bool)
    Fdef[core[0] // 3:core[0] // 2, core[1] // 5:core[1] // 2] = False
    spec = stencil.standard_2d(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C),
                               jnp.asarray(F), jnp.asarray(Fdef),
                               (1.1e5, 1.0e5), bcs, include_cross=cross)
    return spec, jnp.asarray(rng.normal(0.0, 1.0, lead + core))


def _standard3d(bcs, batch=0, seed=0, shape=(6, 10, 14), per_slice=False):
    rng = np.random.default_rng(seed)
    lead = batch if isinstance(batch, tuple) else ((batch,) if batch else ())
    cshape = lead + shape if per_slice else shape
    A = np.abs(rng.normal(1.0, 0.1, cshape)) + 0.5
    B = np.abs(rng.normal(1.0, 0.1, cshape)) + 0.5
    C = np.abs(rng.normal(1.0, 0.1, cshape)) + 0.5
    F = rng.normal(0.0, 1.0, lead + shape)
    Fdef = np.ones(shape, bool)
    z, y, x = shape
    Fdef[z // 3:z // 2 + 1, y // 3:y // 2, x // 4:x // 2] = False
    spec = stencil.standard_3d(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C),
                               jnp.asarray(F), jnp.asarray(Fdef),
                               (5e3, 1.1e5, 1.0e5), bcs)
    return spec, jnp.asarray(rng.normal(0.0, 1.0, lead + shape))


def _bih(bcs, shape=(16, 20), seed=5):
    rng = np.random.default_rng(seed)
    A4 = np.full(shape, 5e3)
    zero = np.zeros(shape)
    D = np.full(shape, -1e-6)
    H = np.full(shape, -1.8e-11)
    J = rng.normal(0, 1e-7, shape)
    return stencil.general_2d_bih(
        jnp.asarray(A4), zero + 1e2, jnp.asarray(A4), jnp.asarray(D), zero,
        jnp.asarray(D), zero, jnp.asarray(H), zero, jnp.asarray(J),
        jnp.ones(shape, bool), (5e4, 5e4), bcs)


@pytest.mark.parametrize("bcs,cross,batch", [
    (("fixed", "fixed"), False, 0),
    (("fixed", "periodic"), False, 0),
    (("extend", "periodic"), False, 0),
    (("extend", "fixed"), False, 0),
    (("fixed", "periodic"), True, 0),
    (("extend", "periodic"), False, 3),
])
def test_sweep_2d_standard(bcs, cross, batch):
    spec, S0 = _standard2d(bcs, batch=batch, cross=cross)
    out = _solve_fixed_xla(spec, S0, 1.4, 9)
    _close(out, redblack_from_spec(spec, S0, 1.4, 9))


@pytest.mark.parametrize("bcs", [
    ("fixed", "fixed"), ("fixed", "periodic"),
    ("extend", "fixed"), ("extend", "periodic"),
])
def test_sweep_2d_biharmonic(bcs):
    spec = _bih(bcs)
    S0 = jnp.asarray(np.random.default_rng(2).normal(0, 1e-3, (16, 20)))
    out = _solve_fixed_xla(spec, S0, 1.0, 7)
    _close(out, redblack_from_spec(spec, S0, 1.0, 7))


def test_sweep_2d_general():
    rng = np.random.default_rng(7)
    shape = (14, 18)
    A = np.abs(rng.normal(1.0, 0.1, shape)) + 0.5
    B = rng.normal(0.0, 0.02, shape)
    C = np.abs(rng.normal(1.0, 0.1, shape)) + 0.5
    D = rng.normal(0, 1e-6, shape)
    E = rng.normal(0, 1e-6, shape)
    Fc = -np.abs(rng.normal(1e-10, 1e-11, shape))
    G = rng.normal(0, 1.0, shape)
    spec = stencil.general_2d(*map(jnp.asarray, (A, B, C, D, E, Fc, G)),
                              jnp.ones(shape, bool), (1.1e5, 1.0e5),
                              ("fixed", "periodic"))
    S0 = jnp.zeros(shape)
    out = _solve_fixed_xla(spec, S0, 1.3, 12)
    _close(out, redblack_from_spec(spec, S0, 1.3, 12))


@pytest.mark.parametrize("bcs,batch,shape", [
    (("fixed", "fixed", "fixed"), 0, (6, 10, 14)),
    (("fixed", "fixed", "periodic"), 0, (6, 10, 14)),
    (("fixed", "extend", "periodic"), 0, (6, 10, 14)),
    (("fixed", "extend", "fixed"), 0, (6, 10, 14)),
    (("fixed", "extend", "periodic"), 3, (6, 10, 14)),
    (("fixed", "fixed", "fixed"), 0, (10, 32, 24)),
    (("fixed", "extend", "periodic"), 0, (10, 32, 28)),
    (("fixed", "extend", "fixed"), 0, (12, 24, 20)),
    (("fixed", "extend", "periodic"), 3, (10, 16, 36)),
    (("fixed", "extend", "periodic"), 0, (48, 18, 20)),
    (("fixed", "extend", "fixed"), 0, (64, 14, 24)),
    (("fixed", "extend", "periodic"), 0, (3, 9, 10)),
    (("fixed", "extend", "periodic"), 0, (25, 9, 12)),
    (("fixed", "fixed", "periodic"), 2, (7, 11, 13)),
    (("fixed", "extend", "fixed"), 0, (5, 33, 9)),
])
def test_sweep_3d_standard(bcs, batch, shape):
    spec, S0 = _standard3d(bcs, batch=batch, shape=shape)
    out = _solve_fixed_xla(spec, S0, 1.2, 6)
    _close(out, redblack_from_spec(spec, S0, 1.2, 6))


@pytest.mark.parametrize("bcs", [("fixed", "fixed", "periodic"),
                                 ("fixed", "extend", "fixed")])
def test_sweep_3d_general(bcs):
    rng = np.random.default_rng(7)
    shape = (5, 12, 16)
    A = np.abs(rng.normal(1.0, 0.1, shape)) + 0.5
    B = np.abs(rng.normal(1.0, 0.1, shape)) + 0.5
    C = np.abs(rng.normal(1.0, 0.1, shape)) + 0.5
    D = rng.normal(0, 1e-6, shape)
    E = rng.normal(0, 1e-6, shape)
    Fc = rng.normal(0, 1e-6, shape)
    G = -np.abs(rng.normal(1e-10, 1e-11, shape))
    H = rng.normal(0, 1.0, shape)
    spec = stencil.general_3d(*map(jnp.asarray, (A, B, C, D, E, Fc, G, H)),
                              jnp.ones(shape, bool), (5e3, 1.1e5, 1.0e5),
                              bcs)
    S0 = jnp.zeros(shape)
    out = _solve_fixed_xla(spec, S0, 1.2, 10)
    _close(out, redblack_from_spec(spec, S0, 1.2, 10))


@pytest.mark.parametrize("bc", ["fixed", "extend"])
def test_sweep_1d(bc):
    rng = np.random.default_rng(3)
    n = 40
    A = np.abs(rng.normal(1.0, 0.1, n)) + 0.5
    spec = stencil.standard_1d(jnp.asarray(A), jnp.asarray(-1e-3 * A),
                               jnp.asarray(rng.normal(0, 1, n)),
                               jnp.ones(n, bool), (1.0,), (bc,))
    S0 = jnp.asarray(rng.normal(0, 1, n))
    out = _solve_fixed_xla(spec, S0, 1.5, 11)
    _close(out, redblack_from_spec(spec, S0, 1.5, 11))


@pytest.mark.parametrize("dim,check_every", [
    (2, 1), (2, 4), (2, 8), (3, 1), (3, 4), (3, 8)])
def test_checked_solve_at_cap(dim, check_every):
    """tol=0: the checked driver runs exactly max_iters sweeps, including a
    remainder window when check_every does not divide it."""
    if dim == 2:
        spec, S0 = _standard2d(("extend", "periodic"), batch=2)
    else:
        spec, S0 = _standard3d(("fixed", "extend", "periodic"), batch=2)
    res = solve(spec, S0, 1.3, tol=0.0, max_iters=10,
                check_every=check_every)
    assert np.all(np.asarray(res.iters) == 10)
    _close(res.S, redblack_from_spec(spec, S0, 1.3, 10))


@pytest.mark.parametrize("dim", [2, 3])
def test_batched_multidim(dim):
    if dim == 2:
        spec, S0 = _standard2d(("extend", "fixed"), batch=(2, 3))
    else:
        spec, S0 = _standard3d(("fixed", "extend", "fixed"), batch=(2, 2))
    out = _solve_fixed_xla(spec, S0, 1.3, 5)
    _close(out, redblack_from_spec(spec, S0, 1.3, 5))


@pytest.mark.parametrize("dim", [2, 3])
def test_per_slice_coefficients(dim):
    if dim == 2:
        spec, S0 = _standard2d(("extend", "periodic"), batch=3,
                               per_slice=True)
    else:
        spec, S0 = _standard3d(("fixed", "extend", "periodic"), batch=2,
                               per_slice=True)
    assert spec.w.ndim == S0.ndim + 1
    out = _solve_fixed_xla(spec, S0, 1.3, 5)
    _close(out, redblack_from_spec(spec, S0, 1.3, 5))


@pytest.mark.parametrize("bcs,bih", [
    (("extend", "periodic"), False), (("extend", "fixed"), False),
    (("extend", "periodic"), True), (("extend", "fixed"), True),
    (("fixed", "extend", "periodic"), False),
    (("fixed", "extend", "fixed"), False),
    (("extend",), False),
])
def test_extend_prepass(bcs, bih):
    """solver._apply_extend against the row-by-row numpy pre-pass."""
    shape = {1: (12,), 2: (9, 11), 3: (5, 9, 11)}[len(bcs)]
    S = np.random.default_rng(4).normal(0, 1, shape)
    spec = stencil.StencilSpec(
        w=jnp.zeros((1,) + shape), w0=jnp.zeros(shape), g=jnp.zeros(shape),
        relax=jnp.zeros(shape), active=jnp.zeros(shape, bool),
        offsets=((1,) + (0,) * (len(bcs) - 1),), bcs=bcs, bih=bih)
    out = solver._apply_extend(spec, jnp.asarray(S))
    np.testing.assert_array_equal(np.asarray(out),
                                  _extend_numpy(S, bcs, bih))


def test_dispatch_keeps_3d_on_xla(monkeypatch):
    """On a GPU, float32 3-D solves still run the XLA sweep."""
    monkeypatch.setattr(solver, "_platform", lambda: "gpu")
    spec, S0 = _standard3d(("fixed", "extend", "periodic"))
    spec32 = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a,
        spec)
    assert solver.choose_sweep(spec32, S0.astype(jnp.float32)).kernel == "xla"


def test_kernel_plan_declines_3d():
    from xinvert_tpu.ops.sor2d import window_plan
    spec, S0 = _standard3d(("fixed", "extend", "periodic"))
    assert window_plan(spec, S0.shape) is None


@pytest.mark.parametrize("n", [1, 2, 7])
def test_solve_fixed_counts(n):
    spec, S0 = _standard2d(("extend", "periodic"), shape=(16, 22))
    out = solver.solve_fixed(spec, S0, 1.5, n)
    _close(out, redblack_from_spec(spec, S0, 1.5, n))


def test_trajectory_frames():
    spec, S0 = _standard2d(("extend", "fixed"))
    frames = solver.solve_trajectory(spec, S0, 1.4, loop_per_frame=3,
                                     max_frames=3)
    for i in range(3):
        _close(frames[i], redblack_from_spec(spec, S0, 1.4, 3 * (i + 1)))
