# -*- coding: utf-8 -*-
"""Engine-level validation: the red-black engine must reach the same
fixed point as a lexicographic reference-semantics oracle, and the control
flow (flags, overflow) must match the reference behavior."""
import numpy as np
import jax.numpy as jnp
import pytest

from xinvert_tpu import stencil, solver
from xinvert_tpu.grid import optimal_omega
from oracle import sor_standard_2d

UNDEF = -9.99e8


def _random_problem(yc, xc, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    A = np.abs(rng.normal(1.0, 0.1, (yc, xc))) + 0.5
    B = np.zeros((yc, xc))
    C = np.abs(rng.normal(1.0, 0.1, (yc, xc))) + 0.5
    F = rng.normal(0.0, 1.0, (yc, xc))
    Fdef = np.ones((yc, xc), bool)
    if mask:
        Fdef[yc // 3:yc // 2, xc // 4:xc // 2] = False
    return A, B, C, F, Fdef


@pytest.mark.parametrize("bcy,bcx,mask", [
    ("fixed", "fixed", False),
    ("fixed", "periodic", False),
    # extend+periodic without interior Dirichlet anchors is singular (pure
    # Neumann-like); masked cells anchor the solution, matching how the
    # reference exercises this BC combination (global ocean with land mask)
    ("extend", "periodic", True),
    ("extend", "fixed", True),
    ("fixed", "periodic", True),
])
def test_standard2d_fixed_point_matches_reference(bcy, bcx, mask):
    yc, xc = 18, 26
    dely, delx = 1.1e5, 1.0e5
    A, B, C, F, Fdef = _random_problem(yc, xc, seed=42, mask=mask)
    omega = optimal_omega((yc, xc))
    near_singular = False

    # oracle operates on sentinel-masked arrays like the reference kernels
    Fm = np.where(Fdef, F, UNDEF)
    S_ref = sor_standard_2d(np.zeros((yc, xc)), A, B, C, Fm, dely, delx,
                            bcy, bcx, omega, UNDEF, n_iters=3000, tol=1e-14)

    spec = stencil.standard_2d(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C),
                               jnp.where(jnp.asarray(Fdef), jnp.asarray(F), 0.0),
                               jnp.asarray(Fdef), (dely, delx), (bcy, bcx),
                               include_cross=False)
    res = solver.solve(spec, jnp.zeros((yc, xc)), omega=omega,
                       tol=1e-14, max_iters=6000)
    S_rb = np.asarray(res.S)

    assert not bool(np.asarray(res.overflow))
    if near_singular:
        # compare modulo the constant null mode
        S_rb = S_rb - S_rb.mean()
        S_ref = S_ref - S_ref.mean()
    scale = np.abs(S_ref).max() + 1e-300
    assert np.allclose(S_rb, S_ref, atol=2e-7 * scale), \
        np.abs(S_rb - S_ref).max() / scale


def test_cross_terms_fixed_point():
    """Eliassen-like problem with B cross-derivative terms."""
    yc, xc = 16, 20
    rng = np.random.default_rng(3)
    A = np.full((yc, xc), 2.0)
    B = rng.normal(0.0, 0.15, (yc, xc))   # small cross term, elliptic
    C = np.full((yc, xc), 1.5)
    F = rng.normal(0.0, 1.0, (yc, xc))
    Fdef = np.ones((yc, xc), bool)
    dely = delx = 1.0
    omega = 1.2
    Fm = F.copy()
    S_ref = sor_standard_2d(np.zeros((yc, xc)), A, B, C, Fm, dely, delx,
                            "fixed", "fixed", omega, UNDEF,
                            n_iters=6000, tol=1e-15)
    spec = stencil.standard_2d(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C),
                               jnp.asarray(F), jnp.asarray(Fdef),
                               (dely, delx), ("fixed", "fixed"))
    res = solver.solve(spec, jnp.zeros((yc, xc)), omega=omega,
                       tol=1e-15, max_iters=10000)
    scale = np.abs(S_ref).max()
    assert np.allclose(np.asarray(res.S), S_ref, atol=1e-7 * scale)


def test_batched_solve_matches_unbatched():
    yc, xc = 12, 16
    A, B, C, F, Fdef = _random_problem(yc, xc, seed=7)
    Fb = np.stack([F, 2.0 * F, -F])
    spec = stencil.standard_2d(jnp.asarray(A), 0.0, jnp.asarray(C),
                               jnp.asarray(Fb), jnp.asarray(Fdef),
                               (1.0, 1.0), ("fixed", "fixed"),
                               include_cross=False)
    res = solver.solve(spec, jnp.zeros_like(jnp.asarray(Fb)), omega=1.3,
                       tol=1e-13, max_iters=3000)
    # single-slice solves
    for k, fk in enumerate([F, 2.0 * F, -F]):
        spec1 = stencil.standard_2d(jnp.asarray(A), 0.0, jnp.asarray(C),
                                    jnp.asarray(fk), jnp.asarray(Fdef),
                                    (1.0, 1.0), ("fixed", "fixed"),
                                    include_cross=False)
        r1 = solver.solve(spec1, jnp.zeros((yc, xc)), omega=1.3,
                          tol=1e-13, max_iters=3000)
        assert np.allclose(np.asarray(res.S[k]), np.asarray(r1.S),
                           rtol=0, atol=1e-9)
    # linearity: solution scales with forcing
    assert np.allclose(np.asarray(res.S[1]), 2.0 * np.asarray(res.S[0]),
                       atol=1e-7 * float(np.abs(res.S[0]).max()))


def test_overflow_flag():
    """omega >= 2 diverges; the overflow flag must trip like the reference
    (numbas.py:403-405)."""
    yc, xc = 10, 12
    A, B, C, F, Fdef = _random_problem(yc, xc, seed=1)
    spec = stencil.standard_2d(jnp.asarray(A), 0.0, jnp.asarray(C),
                               jnp.asarray(F), jnp.asarray(Fdef),
                               (1.0, 1.0), ("fixed", "fixed"),
                               include_cross=False)
    res = solver.solve(spec, jnp.zeros((yc, xc)), omega=2.5,
                       tol=1e-14, max_iters=5000)
    assert bool(np.asarray(res.overflow))
    assert int(np.asarray(res.iters)) < 5000


def test_optimal_omega_bounds():
    """1 <= omega < 2 for any grid (reference tests/test_OptArg.py)."""
    for shape in [(10,), (73, 144), (37, 72, 288), (2, 2), (1000, 1000)]:
        w = optimal_omega(shape)
        assert 1.0 <= w < 2.0


def test_trajectory_matches_fixed():
    yc, xc = 12, 14
    A, B, C, F, Fdef = _random_problem(yc, xc, seed=5)
    spec = stencil.standard_2d(jnp.asarray(A), 0.0, jnp.asarray(C),
                               jnp.asarray(F), jnp.asarray(Fdef),
                               (1.0, 1.0), ("fixed", "fixed"),
                               include_cross=False)
    frames = solver.solve_trajectory(spec, jnp.zeros((yc, xc)), 1.3,
                                     loop_per_frame=4, max_frames=5)
    S20 = solver.solve_fixed(spec, jnp.zeros((yc, xc)), 1.3, 20)
    assert frames.shape == (5, yc, xc)
    assert np.allclose(np.asarray(frames[-1]), np.asarray(S20))


def test_tridiagonal_solvers():
    from xinvert_tpu.ops.tridiag import trace, traceCyclic
    rng = np.random.default_rng(11)
    n = 17
    a = rng.normal(0, 1, n - 1)
    b = rng.normal(0, 1, n) + 6.0       # diagonally dominant
    c = rng.normal(0, 1, n - 1)
    d = rng.normal(0, 1, n)
    M = np.diag(b) + np.diag(a, -1) + np.diag(c, 1)
    x = np.asarray(trace(a, b, c, d))
    assert np.allclose(M @ x, d, atol=1e-10)

    a0, cn = 0.7, -1.3
    Mc = M.copy()
    Mc[0, -1] = a0
    Mc[-1, 0] = cn
    xc_ = np.asarray(traceCyclic(a, b, c, d, a0, cn))
    assert np.allclose(Mc @ xc_, d, atol=1e-10)


def test_check_every_clamps_to_mxloop():
    """checkEvery that does not divide mxLoop must not overrun the cap
    (the last chunk is clamped to the remaining sweeps)."""
    from xinvert_tpu import solver, stencil
    import jax.numpy as jnp
    yc, xc = 17, 19
    A, B, C, F, Fdef = _random_problem(yc, xc, seed=7)
    spec = stencil.standard_2d(jnp.asarray(A), 0.0, jnp.asarray(C),
                               jnp.asarray(F), jnp.asarray(Fdef),
                               (1.0, 1.0), ("fixed", "fixed"),
                               include_cross=False)
    res = solver.solve(spec, jnp.zeros((yc, xc)), omega=1.3, tol=0.0,
                       max_iters=10, check_every=7)
    assert int(res.iters) == 10
    # and the clamped run matches exactly 10 fixed sweeps
    S10 = solver.solve_fixed(spec, jnp.zeros((yc, xc)), 1.3, 10)
    assert np.allclose(np.asarray(res.S), np.asarray(S10))


def test_prune_zero_offsets_exact():
    """Round 5: identically-zero weight planes prune out of the offset
    list with bit-identical sweeps (the Munk-class biharmonic stream
    drops from 20 to 12 plane-equivalents)."""
    import numpy as np
    import jax.numpy as jnp
    from xinvert_tpu import stencil
    from xinvert_tpu.stencil import prune_zero_offsets
    from xinvert_tpu.solver import _solve_fixed_xla, solve

    ny, nx = 64, 96
    rng = np.random.default_rng(3)
    A4 = np.full((ny, nx), 5e3)
    Z = np.zeros((ny, nx))
    beta = np.full((ny, nx), 2e-11)
    J = rng.normal(0, 1e-7, (ny, nx))
    Fdef = np.ones((ny, nx), bool)
    Fdef[20:30, 30:60] = False
    spec = stencil.general_2d_bih(
        jnp.asarray(A4), jnp.asarray(Z), jnp.asarray(A4), jnp.asarray(Z),
        jnp.asarray(Z), jnp.asarray(Z), jnp.asarray(Z),
        jnp.asarray(-beta), jnp.asarray(Z), jnp.asarray(J),
        jnp.asarray(Fdef), (5e4, 5e4), ("fixed", "fixed"))
    pr = prune_zero_offsets(spec)
    assert len(pr.offsets) == 8 and len(spec.offsets) == 16
    S0 = jnp.zeros((ny, nx))
    a = _solve_fixed_xla(spec, S0, 1.0, 25)
    b = _solve_fixed_xla(pr, S0, 1.0, 25)
    # pruning is arithmetically exact, but the pruned program is a
    # DIFFERENT XLA compile and FMA-contraction choices shift the last
    # ulp (the fuzz suite's documented class) — assert at ulp scale
    ulp = 4 * np.finfo(np.asarray(a).dtype).eps * np.abs(a).max()
    assert np.abs(np.asarray(a) - np.asarray(b)).max() <= ulp
    # the checked public solve (which prunes internally) agrees too
    r = solve(spec, S0, 1.0, tol=0.0, max_iters=25)
    assert np.abs(np.asarray(r.S) - np.asarray(a)).max() <= ulp
    # a spec with no zero planes passes through untouched
    spec2 = stencil.standard_2d(
        jnp.asarray(np.abs(rng.normal(1, .1, (ny, nx))) + .5), 0.0,
        jnp.asarray(np.abs(rng.normal(1, .1, (ny, nx))) + .5),
        jnp.asarray(J), jnp.asarray(Fdef), (1e5, 1e5),
        ("fixed", "periodic"))
    assert prune_zero_offsets(spec2) is spec2
