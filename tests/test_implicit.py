# -*- coding: utf-8 -*-
"""Differentiable inversions (ops/implicit.py): implicit-function-theorem
gradients through the SOR solve — a capability with no
reference analog (sensitivity analysis / data assimilation around any
invert_* physics).  Validated against dense transposes and central
finite differences."""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from xinvert_tpu import stencil
from xinvert_tpu.ops.implicit import transpose_spec, solve_implicit


def _prob(ny, nx, bcs, cross=True, seed=0):
    rng = np.random.default_rng(seed)
    A = np.abs(rng.normal(1, .1, (ny, nx))) + .5
    C = np.abs(rng.normal(1, .1, (ny, nx))) + .5
    B = rng.normal(0, .1, (ny, nx)) if cross else 0.0
    F = rng.normal(0, 1, (ny, nx))
    Fdef = np.ones((ny, nx), bool)
    Fdef[ny // 3:ny // 2, nx // 3:nx // 2] = False
    return stencil.standard_2d(
        jnp.asarray(A), jnp.asarray(B) if cross else 0.0, jnp.asarray(C),
        jnp.asarray(F), jnp.asarray(Fdef), (1.1, 1.0), bcs)


def _dense(sp, ny, nx):
    N = ny * nx
    M = np.zeros((N, N))
    act = np.asarray(sp.active).ravel()
    w = np.asarray(sp.w)
    w0 = np.asarray(sp.w0)
    for i in range(N):
        if not act[i]:
            continue
        iy, ix = divmod(i, nx)
        M[i, i] += w0[iy, ix]
        for k, (dy, dx) in enumerate(sp.offsets):
            j = ((iy + dy) % ny) * nx + (ix + dx) % nx
            M[i, j] += w[k][iy, ix]
    return M, act


def test_transpose_spec_dense():
    """transpose_spec's dense restriction to the active set equals the
    dense transpose (cross-coupled 2-D and 3-D stencils)."""
    ny, nx = 12, 16
    sp = _prob(ny, nx, ("fixed", "periodic"))
    M, act = _dense(sp, ny, nx)
    MT, _ = _dense(transpose_spec(sp), ny, nx)
    assert np.abs(M[np.ix_(act, act)].T - MT[np.ix_(act, act)]).max() == 0.0

    rng = np.random.default_rng(3)
    nz, ny3, nx3 = 5, 6, 8
    sh = (nz, ny3, nx3)
    A = np.abs(rng.normal(1, .1, sh)) + .5
    sp3 = stencil.standard_3d(
        jnp.asarray(A), jnp.asarray(A + 1), jnp.asarray(A + 2),
        jnp.asarray(rng.normal(0, 1, sh)), jnp.ones(sh, bool),
        (1.0, 1.1, 1.2), ("fixed", "fixed", "periodic"))
    N = nz * ny3 * nx3

    def dense3(sp):
        M = np.zeros((N, N))
        act = np.asarray(sp.active).ravel()
        w, w0 = np.asarray(sp.w), np.asarray(sp.w0)
        for i in range(N):
            if not act[i]:
                continue
            iz, r = divmod(i, ny3 * nx3)
            iy, ix = divmod(r, nx3)
            M[i, i] += w0[iz, iy, ix]
            for k, (dz, dy, dx) in enumerate(sp.offsets):
                j = (((iz + dz) % nz) * ny3 + (iy + dy) % ny3) * nx3 \
                    + (ix + dx) % nx3
                M[i, j] += w[k][iz, iy, ix]
        return M, act

    M3, act3 = dense3(sp3)
    MT3, _ = dense3(transpose_spec(sp3))
    assert np.abs(M3[np.ix_(act3, act3)].T
                  - MT3[np.ix_(act3, act3)]).max() == 0.0


def _fd_check(loss, args, grads, which, n=5, eps=1e-6, seed=7):
    rng = np.random.default_rng(seed)
    for ai in which:
        arr, bar = args[ai], grads[ai]
        for _ in range(n):
            idx = tuple(rng.integers(0, s) for s in arr.shape)
            da = np.zeros(arr.shape)
            da[idx] = eps
            pos = list(args)
            neg = list(args)
            pos[ai] = arr + jnp.asarray(da)
            neg[ai] = arr - jnp.asarray(da)
            fd = (loss(*pos) - loss(*neg)) / (2 * eps)
            an = float(np.asarray(bar)[idx])
            # absolute floor: FD of a 1e-14-converged solve carries ~1e-9
            # noise, which reads as a huge relative error at zero-gradient
            # entries
            assert abs(float(fd) - an) <= max(1e-4 * abs(an), 1e-7), \
                (ai, idx, float(fd), an)


def test_gradients_match_finite_differences():
    """jax.grad through solve_implicit vs central differences: forcing,
    stencil weights, diagonal and pinned initial values (fixed/periodic,
    cross-coupled, masked)."""
    ny, nx = 12, 16
    sp = _prob(ny, nx, ("fixed", "periodic"))
    rng = np.random.default_rng(1)
    S0 = jnp.asarray(rng.normal(0, 1, (ny, nx)))
    cvec = jnp.asarray(rng.normal(0, 1, (ny, nx)))

    def loss(g, w, w0, S0_):
        s = dataclasses.replace(sp, g=g, w=w, w0=w0)
        return jnp.sum(solve_implicit(s, S0_, tol=1e-14, max_iters=60000,
                                      check_every=1) * cvec)

    args = (sp.g, sp.w, sp.w0, S0)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
    _fd_check(loss, args, grads, which=(0, 1, 2, 3))


def test_gradient_through_coefficient_builder():
    """Chain rule through the (jnp-traced) stencil compiler: gradient of
    the inverted field w.r.t. a physical coefficient PLANE — the
    sensitivity/parameter-estimation workflow."""
    ny, nx = 12, 16
    rng = np.random.default_rng(2)
    A = jnp.asarray(np.abs(rng.normal(1, .1, (ny, nx))) + .5)
    C = jnp.asarray(np.abs(rng.normal(1, .1, (ny, nx))) + .5)
    F = jnp.asarray(rng.normal(0, 1, (ny, nx)))
    Fdef = jnp.ones((ny, nx), bool)
    cvec = jnp.asarray(rng.normal(0, 1, (ny, nx)))

    def loss(Ap):
        sp = stencil.standard_2d(Ap, 0.0, C, F, Fdef, (1.1, 1.0),
                                 ("fixed", "periodic"))
        return jnp.sum(solve_implicit(sp, jnp.zeros((ny, nx)), tol=1e-14,
                                      max_iters=60000, check_every=1)
                       * cvec)

    A_bar = jax.grad(loss)(A)
    rng2 = np.random.default_rng(8)
    eps = 1e-6
    for _ in range(5):
        idx = tuple(rng2.integers(0, s) for s in A.shape)
        da = np.zeros(A.shape)
        da[idx] = eps
        fd = (loss(A + jnp.asarray(da)) - loss(A - jnp.asarray(da))) \
            / (2 * eps)
        an = float(np.asarray(A_bar)[idx])
        assert abs(float(fd) - an) <= max(1e-4 * abs(an), 1e-7), \
            (idx, float(fd), an)


def test_extend_periodic_gradients():
    """The flagship (extend, periodic) class routes through the extend
    fold + a differentiable extension post-step; gradients match FD."""
    ny, nx = 12, 16
    sp = _prob(ny, nx, ("extend", "periodic"), cross=False)
    rng = np.random.default_rng(4)
    S0 = jnp.asarray(rng.normal(0, 1, (ny, nx)))
    cvec = jnp.asarray(rng.normal(0, 1, (ny, nx)))

    def loss(g, S0_):
        s = dataclasses.replace(sp, g=g)
        return jnp.sum(solve_implicit(s, S0_, tol=1e-14, max_iters=60000,
                                      check_every=1) * cvec)

    args = (sp.g, S0)
    grads = jax.grad(loss, argnums=(0, 1))(*args)
    _fd_check(loss, args, grads, which=(0, 1))

    # other extend combinations raise a clear error
    spe = _prob(ny, nx, ("extend", "fixed"), cross=False)
    with pytest.raises(NotImplementedError):
        solve_implicit(spe, jnp.zeros((ny, nx)))


def test_forward_value_matches_solve():
    """The primal is the stock checked solve — identical state."""
    from xinvert_tpu.solver import solve
    ny, nx = 24, 32
    sp = _prob(ny, nx, ("fixed", "periodic"))
    S0 = jnp.zeros((ny, nx))
    a = solve(sp, S0, omega=1.5, tol=1e-12, max_iters=5000,
              check_every=1).S
    b = solve_implicit(sp, S0, omega=1.5, tol=1e-12, max_iters=5000,
                       check_every=1)
    assert np.array_equal(np.asarray(a), np.asarray(b))


def test_transpose_spec_biharmonic_dense():
    """The radius-2 17-point biharmonic stencil transposes exactly (its
    offset set is closed under negation)."""
    ny, nx = 14, 18
    rng = np.random.default_rng(5)
    A4 = jnp.asarray(np.abs(rng.normal(5e3, 100, (ny, nx))))
    Z = jnp.zeros((ny, nx))
    Bc = jnp.asarray(rng.normal(0, 10, (ny, nx)))
    sp = stencil.general_2d_bih(
        A4, Bc, A4, jnp.asarray(rng.normal(0, 1, (ny, nx))), Bc * 1e-2,
        Z, Z, jnp.asarray(-np.abs(rng.normal(2e-11, 1e-12, (ny, nx)))),
        Z, jnp.asarray(rng.normal(0, 1, (ny, nx))),
        jnp.ones((ny, nx), bool), (5e4, 5e4), ("fixed", "fixed"))
    M, act = _dense(sp, ny, nx)
    MT, _ = _dense(transpose_spec(sp), ny, nx)
    assert np.abs(M[np.ix_(act, act)].T - MT[np.ix_(act, act)]).max() == 0.0


def test_batched_gradients():
    """Batched forcing with SHARED weight planes: the weight cotangent
    sums over the batch (broadcast-transpose), the forcing cotangent
    stays per-slice."""
    ny, nx, B = 10, 12, 3
    rng = np.random.default_rng(6)
    A = jnp.asarray(np.abs(rng.normal(1, .1, (ny, nx))) + .5)
    C = jnp.asarray(np.abs(rng.normal(1, .1, (ny, nx))) + .5)
    F = jnp.asarray(rng.normal(0, 1, (B, ny, nx)))
    Fdef = jnp.ones((ny, nx), bool)
    sp = stencil.standard_2d(A, 0.0, C, F, Fdef, (1.1, 1.0),
                             ("fixed", "periodic"))
    S0 = jnp.zeros((B, ny, nx))
    cvec = jnp.asarray(rng.normal(0, 1, (B, ny, nx)))

    def loss(g, w):
        s = dataclasses.replace(sp, g=g, w=w)
        return jnp.sum(solve_implicit(s, S0, tol=1e-14, max_iters=60000,
                                      check_every=1) * cvec)

    grads = jax.grad(loss, argnums=(0, 1))(sp.g, sp.w)
    assert grads[0].shape == sp.g.shape      # per-slice forcing cotangent
    assert grads[1].shape == sp.w.shape      # batch-summed weight cotangent
    _fd_check(loss, (sp.g, sp.w), grads, which=(0, 1))


def test_fixed_count_linearity_identity():
    """The linearity oracle for gradient checks at real widths: at a
    FIXED sweep count (tol=0 never
    triggers the change rule) the truncated solve map is exactly AFFINE
    in the forcing, so the unit-step response loss(g+dg)-loss(g) is (a)
    homogeneous in the step to machine precision even far from
    convergence, and (b) equal to the implicit-diff pairing <g_bar, dg>
    once the solves converge — with NO small-eps FD anywhere."""
    ny, nx = 12, 16
    sp = _prob(ny, nx, ("fixed", "periodic"))
    rng = np.random.default_rng(11)
    S0 = jnp.zeros((ny, nx))
    cvec = jnp.asarray(rng.normal(0, 1, (ny, nx)))
    dg = jnp.where(sp.active, jnp.asarray(rng.normal(0, 1, (ny, nx))), 0.0)

    def loss(g, iters):
        s = dataclasses.replace(sp, g=g)
        return jnp.sum(solve_implicit(s, S0, tol=0.0, max_iters=iters,
                                      check_every=iters) * cvec)

    # (a) affinity of the TRUNCATED map: 40 sweeps is far from converged,
    # yet the step response doubles exactly with the step
    r1 = float(loss(sp.g + dg, 40) - loss(sp.g, 40))
    r2 = float(loss(sp.g + 2.0 * dg, 40) - loss(sp.g, 40))
    assert abs(r2 - 2.0 * r1) <= 1e-10 * max(abs(r1), 1.0)

    # (b) at convergence the unit-step response IS the gradient pairing
    L, g_bar = jax.value_and_grad(lambda g: loss(g, 40000))(sp.g)
    lin = float(loss(sp.g + dg, 40000)) - float(L)
    an = float(jnp.vdot(g_bar, dg))
    assert abs(lin - an) <= 1e-9 * max(abs(an), 1.0), (lin, an)
