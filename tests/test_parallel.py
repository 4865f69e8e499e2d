# -*- coding: utf-8 -*-
"""Distribution layer: sharded solves over a ('batch','y','x') mesh must
reproduce the single-device solution exactly (the sweep is deterministic
dense algebra; GSPMD only changes placement)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from xinvert_tpu import stencil, solve, solve_fixed
from xinvert_tpu.grid import optimal_omega
from xinvert_tpu.parallel import make_grid_mesh, shard_problem, \
    solve_sharded, solve_fixed_sharded


def _problem(batch=4, yc=16, xc=24, seed=0):
    rng = np.random.default_rng(seed)
    A = np.abs(rng.normal(1.0, 0.1, (yc, xc))) + 0.5
    C = np.abs(rng.normal(1.0, 0.1, (yc, xc))) + 0.5
    F = rng.normal(0.0, 1.0, (batch, yc, xc))
    Fdef = np.ones((yc, xc), bool)
    Fdef[5:8, 4:9] = False
    spec = stencil.standard_2d(jnp.asarray(A), 0.0, jnp.asarray(C),
                               jnp.asarray(F), jnp.asarray(Fdef),
                               (1.1e5, 1.0e5), ("fixed", "periodic"),
                               include_cross=False)
    S0 = jnp.zeros((batch, yc, xc))
    return spec, S0


def test_mesh_factorization():
    mesh = make_grid_mesh(8, batch=2)
    assert mesh.shape == {"batch": 2, "y": 1, "x": 4} or \
        mesh.shape == {"batch": 2, "y": 2, "x": 2}
    mesh = make_grid_mesh(8)
    assert mesh.shape["batch"] == 1
    assert mesh.shape["y"] * mesh.shape["x"] == 8
    with pytest.raises(ValueError):
        make_grid_mesh(8, batch=3)


def test_sharded_solve_matches_single_device():
    spec, S0 = _problem()
    omega = optimal_omega(S0.shape[-2:])

    single = solve(spec, S0, omega=omega, tol=1e-13, max_iters=3000)
    for batch_ax in (1, 2):
        mesh = make_grid_mesh(8, batch=batch_ax)
        shard = solve_sharded(spec, S0, mesh=mesh, omega=omega,
                              tol=1e-13, max_iters=3000)
        np.testing.assert_allclose(np.asarray(shard.S), np.asarray(single.S),
                                   rtol=0, atol=1e-12)
        assert (np.asarray(shard.iters) == np.asarray(single.iters)).all()


def test_sharded_fixed_matches_single_device():
    spec, S0 = _problem()
    omega = optimal_omega(S0.shape[-2:])
    single = solve_fixed(spec, S0, omega, 50)
    mesh = make_grid_mesh(8, batch=2)
    shard = solve_fixed_sharded(spec, S0, 50, mesh=mesh, omega=omega)
    # partitioned compilation may reassociate fp ops; tolerance stays at
    # a few ulps of the solution scale
    np.testing.assert_allclose(np.asarray(shard), np.asarray(single),
                               rtol=1e-11, atol=1e-11)


def test_sharded_biharmonic():
    """Two-ring halo problem (biharmonic 13-point stencil) shards too."""
    rng = np.random.default_rng(1)
    yc, xc = 24, 32
    shape = (yc, xc)
    A4 = np.full(shape, 5e3)
    zero = np.zeros(shape)
    D = np.full(shape, -1e-6)
    H = np.full(shape, -1.8e-11)
    J = rng.normal(0, 1e-7, shape)
    spec = stencil.general_2d_bih(
        jnp.asarray(A4), zero, jnp.asarray(A4), jnp.asarray(D), zero,
        jnp.asarray(D), zero, jnp.asarray(H), zero, jnp.asarray(J),
        jnp.ones(shape, bool), (5e4, 5e4), ("fixed", "fixed"))
    S0 = jnp.zeros(shape)
    omega = 1.2
    single = solve_fixed(spec, S0, omega, 40)
    mesh = make_grid_mesh(4, batch=1)
    shard = solve_fixed_sharded(spec, S0, 40, mesh=mesh, omega=omega)
    scale = np.abs(np.asarray(single)).max()
    np.testing.assert_allclose(np.asarray(shard), np.asarray(single),
                               rtol=1e-12, atol=1e-12 * max(scale, 1.0))


@pytest.mark.parametrize("bcs", [
    ("fixed", "fixed"),
    ("fixed", "periodic"),
    ("extend", "periodic"),
])
def test_halo_executor_matches_single_device(bcs):
    """Explicit shard_map + ppermute halo exchange reproduces the XLA roll
    path across BCs, including global red/black parity and edge extends."""
    from xinvert_tpu.parallel.halo import solve_fixed_halo
    rng = np.random.default_rng(3)
    yc, xc = 16, 24
    A = np.abs(rng.normal(1.0, 0.1, (yc, xc))) + 0.5
    C = np.abs(rng.normal(1.0, 0.1, (yc, xc))) + 0.5
    F = rng.normal(0.0, 1.0, (yc, xc))
    Fdef = np.ones((yc, xc), bool)
    Fdef[5:8, 4:9] = False
    spec = stencil.standard_2d(jnp.asarray(A), 0.0, jnp.asarray(C),
                               jnp.asarray(F), jnp.asarray(Fdef),
                               (1.1e5, 1.0e5), bcs, include_cross=False)
    S0 = jnp.zeros((yc, xc))
    omega = optimal_omega((yc, xc))
    single = solve_fixed(spec, S0, omega, 30)
    mesh = make_grid_mesh(8, batch=1)   # 2x4 or similar spatial mesh
    halo = solve_fixed_halo(spec, S0, omega, 30, mesh=mesh)
    np.testing.assert_allclose(np.asarray(halo), np.asarray(single),
                               rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("bcs", [
    ("fixed", "periodic"),
    ("extend", "periodic"),
    ("extend", "fixed"),
])
def test_halo_executor_biharmonic(bcs):
    from xinvert_tpu.parallel.halo import solve_fixed_halo
    rng = np.random.default_rng(4)
    yc, xc = 16, 32
    shape = (yc, xc)
    A4 = np.full(shape, 5e3)
    zero = np.zeros(shape)
    D = np.full(shape, -1e-6)
    H = np.full(shape, -1.8e-11)
    J = rng.normal(0, 1e-7, shape)
    spec = stencil.general_2d_bih(
        jnp.asarray(A4), zero + 1e2, jnp.asarray(A4), jnp.asarray(D), zero,
        jnp.asarray(D), zero, jnp.asarray(H), zero, jnp.asarray(J),
        jnp.ones(shape, bool), (5e4, 5e4), bcs)
    S0 = jnp.zeros(shape)
    single = solve_fixed(spec, S0, 1.0, 20)
    mesh = make_grid_mesh(8, batch=1)
    halo = solve_fixed_halo(spec, S0, 1.0, 20, mesh=mesh)
    np.testing.assert_allclose(np.asarray(halo), np.asarray(single),
                               rtol=1e-11, atol=1e-16)


def test_halo_executor_batched():
    """Batch dims ride through the halo executor unsharded; a 2-D S with a
    batched spec is rejected with a clear error."""
    from xinvert_tpu.parallel.halo import solve_fixed_halo
    spec, S0 = _problem(batch=3, yc=16, xc=24)
    omega = optimal_omega(S0.shape[-2:])
    single = solve_fixed(spec, S0, omega, 30)
    mesh_all = make_grid_mesh(8, batch=2)
    sub = jax.sharding.Mesh(np.asarray(mesh_all.devices)[0], ("y", "x"))
    halo = solve_fixed_halo(spec, S0, omega, 30, mesh=sub)
    np.testing.assert_allclose(np.asarray(halo), np.asarray(single),
                               rtol=1e-11, atol=1e-11)
    with pytest.raises(ValueError):
        solve_fixed_halo(spec, S0[0], omega, 5, mesh=sub)


def test_dryrun_entry():
    import sys
    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(out)).all()


def test_sharded_3d_omega():
    """3-D spec sharded over ('batch','y','x') with z unsharded — the
    BASELINE 'omega across hosts' configuration, on virtual devices."""
    from xinvert_tpu.grid import Grid
    from xinvert_tpu.models import problems
    from xinvert_tpu.models.params import default_mParams, merge_params

    nz, ny, nx = 7, 12, 16
    lev = np.linspace(100000, 10000, nz)
    lat = np.linspace(-80, 80, ny)
    lon = np.linspace(0, 360 - 360 / nx, nx)
    grid = Grid.make(("lev", "lat", "lon"), (lev, lat, lon), "lat-lon",
                     bcs=("fixed", "fixed", "periodic"))
    rng = np.random.default_rng(0)
    F = jnp.asarray(rng.normal(0, 1e-15, (nz, ny, nx)))
    mp = merge_params(default_mParams, {"N2": 2e-4})
    spec = problems.build_omega(F, jnp.ones((nz, ny, nx), bool), grid, mp)
    S0 = jnp.zeros((nz, ny, nx))

    single = solve(spec, S0, tol=1e-12, max_iters=2000)
    mesh = make_grid_mesh(4, batch=1)         # z replicated, (y, x) spatial
    shard = solve_sharded(spec, S0, mesh=mesh, tol=1e-12, max_iters=2000)
    np.testing.assert_allclose(np.asarray(shard.S), np.asarray(single.S),
                               rtol=1e-11, atol=1e-11)
    assert int(shard.iters) == int(single.iters)


def test_sharded_mg_matches_single_device():
    """solve_mg with the pyramid sharded over ('y','x') reproduces the
    single-device V-cycle (line-smoother scans may reassociate, so
    allclose rather than bit-equal) and still converges."""
    from xinvert_tpu.mg import build_pyramid_standard2d, solve_mg
    from xinvert_tpu.parallel import solve_mg_sharded

    ny, nx = 128, 128            # cell-coarsened levels 128->64->32->16
    rng = np.random.default_rng(2)  # stay mesh-divisible (device_put needs it)
    A = np.abs(rng.normal(1, .05, (ny, nx))) + 1.0
    C = np.abs(rng.normal(1, .05, (ny, nx))) + 1.0
    F = rng.normal(0, 1, (ny, nx))
    Fdef = np.ones((ny, nx), bool)
    Fdef[40:55, 30:90] = False
    pyr = build_pyramid_standard2d(A, 0.0, C, F, Fdef, (1.2e5, 1.0e5),
                                   ("fixed", "periodic"))
    S, k, res, conv = solve_mg(pyr, tol=1e-8, max_cycles=40)
    assert conv

    mesh = make_grid_mesh(8, batch=1)
    Ssh, ksh, res_sh, conv_sh = solve_mg_sharded(pyr, mesh=mesh, tol=1e-8,
                                                 max_cycles=40)
    assert conv_sh and res_sh < 1e-8
    scale = np.abs(np.asarray(S)).max()
    np.testing.assert_allclose(np.asarray(Ssh), np.asarray(S),
                               rtol=0, atol=1e-9 * scale)


def test_sharded_mg_batched():
    """Batched V-cycles (shared operator, per-member forcing) shard over
    the mesh 'batch' axis and match the unsharded batched solve."""
    from xinvert_tpu.mg import build_pyramid_standard2d, solve_mg
    from xinvert_tpu.parallel import solve_mg_sharded

    ny, nx, B = 64, 64, 4
    rng = np.random.default_rng(5)
    A = np.abs(rng.normal(1, .05, (ny, nx))) + 1.0
    C = np.abs(rng.normal(1, .05, (ny, nx))) + 1.0
    F = rng.normal(0, 1, (ny, nx))
    Fdef = np.ones((ny, nx), bool)
    pyr = build_pyramid_standard2d(A, 0.0, C, F, Fdef, (1.2e5, 1.0e5),
                                   ("fixed", "fixed"))
    # folded per-member constant terms: scaled copies of the fine g
    g0 = jnp.stack([(0.5 + 0.5 * b) * pyr[0].spec.g for b in range(B)])
    S0 = jnp.zeros((B, ny, nx))
    S, k, res, conv = solve_mg(pyr, S0, g0=g0, tol=1e-8, max_cycles=30)
    assert conv

    mesh = make_grid_mesh(8, batch=2)
    Ssh, ksh, res_sh, conv_sh = solve_mg_sharded(
        pyr, S0, g0=g0, mesh=mesh, tol=1e-8, max_cycles=30)
    assert conv_sh and res_sh < 1e-8
    scale = np.abs(np.asarray(S)).max()
    np.testing.assert_allclose(np.asarray(Ssh), np.asarray(S),
                               rtol=0, atol=1e-9 * scale)


def test_sharded_mg_3d_semicoarsened():
    """The 3-D semicoarsened pyramid (z-line smoothing, z replicated)
    solves under ('y','x') sharding — the omega-across-hosts MG path."""
    from xinvert_tpu.mg import build_pyramid_standard3d, solve_mg
    from xinvert_tpu.parallel import solve_mg_sharded

    nz, ny, nx = 6, 32, 32
    rng = np.random.default_rng(7)
    A = np.full((nz, ny, nx), 1e-8)
    Bc = np.abs(rng.normal(1, .05, (nz, ny, nx))) + 1.0
    C = np.abs(rng.normal(1, .05, (nz, ny, nx))) + 1.0
    F = rng.normal(0, 1, (nz, ny, nx))
    Fdef = np.ones((nz, ny, nx), bool)
    pyr = build_pyramid_standard3d(A, Bc, C, F, Fdef, (7e3, 1.2e5, 1.0e5),
                                   ("fixed", "fixed", "periodic"))
    S, k, res, conv = solve_mg(pyr, tol=1e-7, max_cycles=40)
    assert conv

    mesh = make_grid_mesh(4, batch=1)
    Ssh, ksh, res_sh, conv_sh = solve_mg_sharded(pyr, mesh=mesh, tol=1e-7,
                                                 max_cycles=40)
    assert conv_sh and res_sh < 1e-7
    scale = np.abs(np.asarray(S)).max()
    np.testing.assert_allclose(np.asarray(Ssh), np.asarray(S),
                               rtol=0, atol=1e-8 * scale)


def test_halo_traffic_one_packed_exchange_per_half_sweep():
    """The latency-optimized executor moves ONE color-packed ring per
    half-sweep for nearest-neighbor stencils: exchanged bytes per iteration
    equal 2*(bx + by) elements per device — a ~4x cut from the round-1
    pad + extend-re-pad + per-color re-pad pattern (VERDICT item 7)."""
    from xinvert_tpu import stencil
    from xinvert_tpu.parallel.halo import (solve_fixed_halo,
                                           last_traffic_bytes_per_iter)
    from xinvert_tpu.solver import solve_fixed

    ny, nx = 32, 64
    rng = np.random.default_rng(3)
    A = np.abs(rng.normal(1, .05, (ny, nx))) + 1.0
    C = np.abs(rng.normal(1, .05, (ny, nx))) + 1.0
    F = rng.normal(0, 1, (ny, nx))
    Fdef = np.ones((ny, nx), bool)
    Fdef[10:14, 20:30] = False
    spec = stencil.standard_2d(jnp.asarray(A), 0.0, jnp.asarray(C),
                               jnp.asarray(F), jnp.asarray(Fdef),
                               (1.0, 1.0), ("extend", "periodic"),
                               include_cross=False)
    mesh = make_grid_mesh(8)                     # 4x2 or 2x4 (y, x)
    my_, mx_ = mesh.shape["y"], mesh.shape["x"]
    by, bx = ny // my_, nx // mx_

    out = solve_fixed_halo(spec, jnp.zeros((ny, nx)), 1.6, 7, mesh=mesh)
    ref = solve_fixed(spec, jnp.zeros((ny, nx)), 1.6, 7, use_kernel=False)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-12, atol=1e-12)

    itemsize = np.dtype(np.float64).itemsize
    expected = 2 * (bx + by) * itemsize          # 2 half-packed exchanges
    assert last_traffic_bytes_per_iter() == expected, (
        last_traffic_bytes_per_iter(), expected)


def test_halo_traffic_cross_stencil_full_rings():
    """Diagonal couplings read both colors: full rings, still only one
    exchange per half-sweep (2 per iteration)."""
    from xinvert_tpu import stencil
    from xinvert_tpu.parallel.halo import (solve_fixed_halo,
                                           last_traffic_bytes_per_iter)
    from xinvert_tpu.solver import solve_fixed

    ny, nx = 32, 64
    rng = np.random.default_rng(4)
    A = np.abs(rng.normal(1, .05, (ny, nx))) + 1.0
    B = rng.normal(0, .1, (ny, nx))
    C = np.abs(rng.normal(1, .05, (ny, nx))) + 1.0
    F = rng.normal(0, 1, (ny, nx))
    spec = stencil.standard_2d(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C),
                               jnp.asarray(F), jnp.ones((ny, nx), bool),
                               (1.0, 1.0), ("fixed", "fixed"))
    mesh = make_grid_mesh(8)
    my_, mx_ = mesh.shape["y"], mesh.shape["x"]
    by, bx = ny // my_, nx // mx_

    out = solve_fixed_halo(spec, jnp.zeros((ny, nx)), 1.4, 6, mesh=mesh)
    ref = solve_fixed(spec, jnp.zeros((ny, nx)), 1.4, 6, use_kernel=False)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-12, atol=1e-12)

    itemsize = np.dtype(np.float64).itemsize
    # 2 exchanges x (2 y-rings of bx + 2 x-rings of by+2 on the padded
    # block), ring width 1
    expected = 2 * (2 * bx + 2 * (by + 2)) * itemsize
    assert last_traffic_bytes_per_iter() == expected, (
        last_traffic_bytes_per_iter(), expected)


def test_scaling_bench_schema():
    """The scaling harness produces the BASELINE efficiency-table schema on
    whatever mesh exists (virtual CPU here; unchanged on real slices)."""
    from xinvert_tpu.parallel import scaling_bench, format_scaling_table

    rows = scaling_bench(device_counts=[1, 4], base_ny=64, base_nx=64,
                         n_iters=10)
    assert [r["devices"] for r in rows] == [1, 4]
    for r in rows:
        assert set(r) == {"devices", "mesh", "grid", "pts_per_s",
                          "pts_per_s_per_device", "efficiency"}
        assert r["pts_per_s"] > 0
    assert rows[0]["efficiency"] == 1.0
    table = format_scaling_table(rows)
    assert "devices" in table and "eff" in table


def test_initialize_distributed_single_process():
    from xinvert_tpu.parallel import initialize_distributed
    assert initialize_distributed() is False      # single-process: no DCN


def test_hybrid_mesh_single_host():
    from xinvert_tpu.parallel import make_hybrid_mesh
    mesh = make_hybrid_mesh()
    assert tuple(mesh.axis_names) == ("batch", "y", "x")


@pytest.mark.parametrize("bcs,k", [
    (("fixed", "fixed"), 2),
    (("fixed", "periodic"), 2),
    (("extend", "periodic"), 2),
    (("extend", "periodic"), 4),
])
def test_halo_kavoid_matches_single_device(bcs, k):
    """Communication-avoiding executor (one exchange per k iterations,
    ghost zones covering the k-sweep cone) is bit-equal to the XLA path,
    including non-multiple iteration counts."""
    from xinvert_tpu.parallel.halo import solve_fixed_halo
    rng = np.random.default_rng(5)
    yc, xc = 32, 48
    A = np.abs(rng.normal(1.0, 0.1, (yc, xc))) + 0.5
    C = np.abs(rng.normal(1.0, 0.1, (yc, xc))) + 0.5
    F = rng.normal(0.0, 1.0, (yc, xc))
    Fdef = np.ones((yc, xc), bool)
    Fdef[11:17, 9:30] = False
    spec = stencil.standard_2d(jnp.asarray(A), 0.0, jnp.asarray(C),
                               jnp.asarray(F), jnp.asarray(Fdef),
                               (1.1e5, 1.0e5), bcs, include_cross=False)
    S0 = jnp.zeros((yc, xc))
    omega = optimal_omega((yc, xc))
    mesh = make_grid_mesh(8, batch=1)
    for n in (k, 2 * k + 1, 7):
        single = solve_fixed(spec, S0, omega, n)
        halo = solve_fixed_halo(spec, S0, omega, n, mesh=mesh, k_sweeps=k)
        np.testing.assert_allclose(np.asarray(halo), np.asarray(single),
                                   rtol=1e-12, atol=1e-12)


def test_halo_kavoid_biharmonic():
    from xinvert_tpu.parallel.halo import solve_fixed_halo
    rng = np.random.default_rng(7)
    yc, xc = 32, 48
    shape = (yc, xc)
    A4 = np.full(shape, 5e3)
    zero = np.zeros(shape)
    D = np.full(shape, -1e-6)
    H = np.full(shape, -1.8e-11)
    J = rng.normal(0, 1e-7, shape)
    spec = stencil.general_2d_bih(
        jnp.asarray(A4), zero + 1e2, jnp.asarray(A4), jnp.asarray(D), zero,
        jnp.asarray(D), zero, jnp.asarray(H), zero, jnp.asarray(J),
        jnp.ones(shape, bool), (5e4, 5e4), ("extend", "periodic"))
    S0 = jnp.zeros(shape)
    single = solve_fixed(spec, S0, 1.0, 10)
    mesh = make_grid_mesh(8, batch=1)
    halo = solve_fixed_halo(spec, S0, 1.0, 10, mesh=mesh, k_sweeps=2)
    np.testing.assert_allclose(np.asarray(halo), np.asarray(single),
                               rtol=1e-12, atol=1e-18)


def test_halo_kavoid_rejects_thin_blocks():
    from xinvert_tpu.parallel.halo import solve_fixed_halo
    rng = np.random.default_rng(0)
    yc, xc = 16, 24
    A = np.abs(rng.normal(1.0, 0.1, (yc, xc))) + 0.5
    spec = stencil.standard_2d(jnp.asarray(A), 0.0, jnp.asarray(A),
                               jnp.asarray(rng.normal(0, 1, (yc, xc))),
                               jnp.ones((yc, xc), bool), (1.1e5, 1.0e5),
                               ("fixed", "periodic"), include_cross=False)
    mesh = make_grid_mesh(8, batch=1)
    with pytest.raises(ValueError, match="halo width"):
        solve_fixed_halo(spec, jnp.zeros((yc, xc)), 1.4, 4, mesh=mesh,
                         k_sweeps=8)


# ---------------------------------------------------------------------------
# 3-D halo executor (round 3): z device-local, y/x ghost rings
# ---------------------------------------------------------------------------

def _spec3d(bcs, batch=0, seed=11):
    rng = np.random.default_rng(seed)
    zc, yc, xc = 6, 16, 24
    shape3 = (zc, yc, xc)
    A = np.abs(rng.normal(1.0, 0.1, shape3)) + 0.5
    B = np.abs(rng.normal(1.0, 0.1, shape3)) + 0.5
    C = np.abs(rng.normal(1.0, 0.1, shape3)) + 0.5
    shape = ((batch,) + shape3 if batch else shape3)
    F = rng.normal(0.0, 1.0, shape)
    Fdef = np.ones(shape3, bool)
    Fdef[2:4, 5:8, 6:12] = False
    spec = stencil.standard_3d(jnp.asarray(A), jnp.asarray(B),
                               jnp.asarray(C), jnp.asarray(F),
                               jnp.asarray(Fdef), (5e3, 1.1e5, 1.0e5), bcs)
    return spec, jnp.zeros(shape)


@pytest.mark.parametrize("bcs,k", [
    (("fixed", "fixed", "fixed"), 1),
    (("fixed", "fixed", "periodic"), 1),
    (("fixed", "extend", "periodic"), 1),
    (("fixed", "extend", "periodic"), 2),
    (("fixed", "extend", "fixed"), 2),
])
def test_halo_3d_matches_single_device(bcs, k):
    """The 3-D omega-family volumes shard y/x with ghost rings while z
    stays device-local (VERDICT r2 item 5); bit-equal to the XLA sweep
    including the interior-z extend pre-pass and 3-D red/black parity."""
    from xinvert_tpu.parallel.halo import solve_fixed_halo
    spec, S0 = _spec3d(bcs)
    mesh = make_grid_mesh(8, batch=1)
    for n in (k, 2 * k + 1):
        single = solve_fixed(spec, S0, 1.3, n)
        halo = solve_fixed_halo(spec, S0, 1.3, n, mesh=mesh, k_sweeps=k)
        np.testing.assert_allclose(np.asarray(halo), np.asarray(single),
                                   rtol=1e-12, atol=1e-12)


def test_halo_3d_general_family():
    """general_3d (damped advective 3DOcean family) through the same
    executor: first-derivative z coupling rides local z rolls."""
    from xinvert_tpu.parallel.halo import solve_fixed_halo
    rng = np.random.default_rng(13)
    shape = (5, 16, 24)
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
                              ("fixed", "fixed", "periodic"))
    S0 = jnp.zeros(shape)
    mesh = make_grid_mesh(8, batch=1)
    single = solve_fixed(spec, S0, 1.4, 9)
    halo = solve_fixed_halo(spec, S0, 1.4, 9, mesh=mesh, k_sweeps=2)
    np.testing.assert_allclose(np.asarray(halo), np.asarray(single),
                               rtol=1e-12, atol=1e-12)


def test_halo_3d_batched():
    from xinvert_tpu.parallel.halo import solve_fixed_halo
    spec, S0 = _spec3d(("fixed", "extend", "periodic"), batch=3)
    mesh = make_grid_mesh(8, batch=1)
    single = solve_fixed(spec, S0, 1.3, 6)
    halo = solve_fixed_halo(spec, S0, 1.3, 6, mesh=mesh, k_sweeps=2)
    np.testing.assert_allclose(np.asarray(halo), np.asarray(single),
                               rtol=1e-12, atol=1e-12)
