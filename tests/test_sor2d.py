# -*- coding: utf-8 -*-
"""The fused 2-D sweep kernel's Python side (ops/sor2d.py), on the CPU:
its window plan, the plan's jnp executor (the kernel's arithmetic
reference) against the XLA sweep, the solver's kernel path with the
executor standing in for the CUDA launch, the FFI call it forms, the
build, and the one dispatch function (solver.choose_sweep) with the
platform monkeypatched.  The CUDA kernel itself is checked on a GPU by
tests/test_chip.py."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from xinvert_tpu import stencil, solver
from xinvert_tpu.ops import sor2d, cuda_build
from xinvert_tpu.solver import _solve_fixed_xla


def _close(a, b, tol=1e-11):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * np.abs(b).max())


def _problem(bcs, shape=(70, 46), batch=0, mask=True, cross=False,
             bih=False, per_slice=False, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    lead = batch if isinstance(batch, tuple) else ((batch,) if batch else ())
    cshape = lead + shape if per_slice else shape
    A = np.abs(rng.normal(1, .1, cshape)) + .5
    C = np.abs(rng.normal(1, .1, cshape)) + .5
    B = rng.normal(0, .1, cshape) if cross else np.zeros(cshape)
    F = rng.normal(0, 1, lead + shape)
    Fdef = np.ones(shape, bool)
    if mask:
        Fdef[shape[0] // 3:shape[0] // 2, shape[1] // 4:shape[1] // 2] = False
    if bih:
        Z = np.zeros(cshape)
        spec = stencil.general_2d_bih(
            *(jnp.asarray(a, dtype) for a in (A, Z, C, -A * 1e-3, B,
                                              -C * 1e-3, Z, Z, Z, F)),
            jnp.asarray(Fdef), (1.1, 1.0), bcs)
    else:
        spec = stencil.standard_2d(*(jnp.asarray(a, dtype) for a in
                                     (A, B, C, F)), jnp.asarray(Fdef),
                                   (1.1, 1.0), bcs, include_cross=cross)
    return spec, jnp.asarray(rng.normal(0, 1, lead + shape), dtype)


def _run_plan(spec, S0, omega, n, plan):
    """n sweeps as the kernel runs them: launches of plan.k sweeps, each
    through launch_jnp."""
    planes = sor2d.prepare_planes(spec, S0.shape, omega, S0.dtype)
    S3 = S0.reshape((-1,) + S0.shape[-2:])
    done = 0
    while done < n:
        m = min(plan.k, n - done)
        S3 = sor2d.launch_jnp(plan, spec, S3, *planes, m)
        done += m
    return S3.reshape(S0.shape)


@pytest.fixture
def kernel_on_cpu(monkeypatch):
    """The solver's kernel path on the CPU: the platform reads as a GPU
    and each launch runs the jnp executor of the same plan."""
    monkeypatch.setattr(solver, "_platform", lambda: "gpu")
    monkeypatch.setattr(sor2d, "_launch", sor2d.launch_jnp)


# ---------------------------------------------------------------- executor

@pytest.mark.parametrize("bcs,mask,cross", [
    (("fixed", "fixed"), False, False),
    (("fixed", "periodic"), True, False),
    (("extend", "periodic"), True, False),
    (("extend", "fixed"), False, True),
    (("fixed", "periodic"), True, True),
])
def test_executor_matches_xla(bcs, mask, cross):
    spec, S0 = _problem(bcs, mask=mask, cross=cross)
    plan = sor2d.window_plan(spec, S0.shape, win_x=24, win_points=24 * 24)
    assert plan is not None and plan.tile_y < 70 and plan.tile_x < 46
    _close(_run_plan(spec, S0, 1.5, 9, plan), _solve_fixed_xla(spec, S0, 1.5, 9))


@pytest.mark.parametrize("bcs", [("fixed", "fixed"), ("fixed", "periodic"),
                                 ("extend", "fixed"), ("extend", "periodic")])
def test_executor_biharmonic(bcs):
    spec, S0 = _problem(bcs, bih=True)
    spec = stencil.prune_zero_offsets(spec)
    plan = sor2d.window_plan(spec, S0.shape, win_x=32, win_points=32 * 36)
    assert plan.halo == 2 * 2 * plan.k
    _close(_run_plan(spec, S0, 1.0, 5, plan), _solve_fixed_xla(spec, S0, 1.0, 5))


def test_executor_nonmultiple_sweep_count():
    spec, S0 = _problem(("extend", "periodic"))
    plan = sor2d.window_plan(spec, S0.shape, win_x=24, win_points=24 * 24)
    assert 11 % plan.k
    _close(_run_plan(spec, S0, 1.5, 11, plan),
           _solve_fixed_xla(spec, S0, 1.5, 11))


@pytest.mark.parametrize("per_slice", [False, True])
def test_executor_batched(per_slice):
    spec, S0 = _problem(("extend", "periodic"), shape=(40, 24), batch=3,
                        per_slice=per_slice)
    plan = sor2d.window_plan(spec, S0.shape, win_x=24, win_points=24 * 24)
    _close(_run_plan(spec, S0, 1.5, 6, plan), _solve_fixed_xla(spec, S0, 1.5, 6))


def test_executor_batched_extra_leading_dims():
    spec, S0 = _problem(("extend", "fixed"), shape=(40, 24), batch=(2, 2))
    plan = sor2d.window_plan(spec, S0.shape, win_x=24, win_points=24 * 24)
    _close(_run_plan(spec, S0, 1.5, 6, plan), _solve_fixed_xla(spec, S0, 1.5, 6))


@pytest.mark.parametrize("shape", [(301, 257), (97, 300), (33, 17), (9, 8)])
def test_executor_odd_sizes(shape):
    bcs = ("extend", "fixed") if shape[1] % 2 else ("extend", "periodic")
    spec, S0 = _problem(bcs, shape=shape, mask=shape[0] > 16)
    plan = sor2d.window_plan(spec, S0.shape, win_x=48, win_points=48 * 40)
    assert plan is not None
    _close(_run_plan(spec, S0, 1.4, 5, plan), _solve_fixed_xla(spec, S0, 1.4, 5))


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_executor(seed):
    """Random boundaries, sizes, stencils and window geometry."""
    rng = np.random.default_rng(100 + seed)
    bcs = (str(rng.choice(["fixed", "extend", "periodic"])),
           str(rng.choice(["fixed", "periodic"])))
    bih = bool(rng.integers(2))
    ny = int(rng.integers(12, 60))
    nx = int(rng.integers(6, 30)) * 2
    batch = int(rng.integers(0, 3))
    spec, S0 = _problem(bcs, shape=(ny, nx), batch=batch,
                        cross=bool(rng.integers(2)), bih=bih, seed=seed)
    wx = int(rng.choice([16, 24, 32, 40]))
    plan = sor2d.window_plan(spec, S0.shape, win_x=wx,
                             win_points=wx * int(rng.integers(20, 40)),
                             max_k=int(rng.integers(1, 5)))
    if plan is None:
        pytest.skip("no window fits this draw")  # pragma: no cover
    n = int(rng.integers(1, 10))
    om = 1.0 if bih else 1.5
    _close(_run_plan(spec, S0, om, n, plan), _solve_fixed_xla(spec, S0, om, n))


# ---------------------------------------------------------------- plan

def test_plan_properties():
    """The default plan at the flagship width: halo covers k sweeps of a
    radius-1 stencil, the window fits the kernel's shared memory and
    thread slots, and tiles keep at least 8 rows and columns."""
    spec, S0 = _problem(("extend", "periodic"), shape=(256, 256))
    K = len(spec.offsets)
    plan = sor2d.window_plan(spec, (2048, 2048))
    assert plan.halo == 2 * plan.k and plan.k == 4
    assert plan.win_y == plan.tile_y + 2 * plan.halo
    assert plan.win_x == plan.tile_x + 2 * plan.halo == sor2d.WIN_X
    assert (K + 4) * plan.win_y * plan.win_x * 4 <= sor2d.SMEM_BYTES
    assert plan.win_y * plan.win_x <= sor2d.MAX_WINDOW_POINTS
    assert plan.win_y * ((plan.win_x + 1) // 2) <= sor2d.MAX_HALF_POINTS
    assert min(plan.tile_y, plan.tile_x) >= 8


@pytest.mark.parametrize("shape", [(2048, 2048), (721, 1440), (73, 144),
                                   (330, 720)])
def test_plan_shapes_real_widths(shape):
    """Plans at the widths users run; every cell is owned by exactly one
    block, inside its window with the ghost margin on every side that is
    not a domain edge."""
    spec, _ = _problem(("extend", "periodic"), shape=(32, 32))
    plan = sor2d.window_plan(spec, shape)
    geo = sor2d.window_geometry(plan, *shape, spec.bcs, spec.bih)
    by, bx, ly, lx = geo.owner
    ny, nx = shape
    rows = geo.rows[by, ly]
    cols = geo.cols[bx, lx]
    np.testing.assert_array_equal(rows, np.broadcast_to(
        np.arange(ny)[:, None], shape))
    np.testing.assert_array_equal(cols, np.broadcast_to(
        np.arange(nx)[None, :], shape))
    gy = np.arange(ny)[:, None]
    top_ok = (ly >= plan.halo) | (geo.y0[by] == 0)
    bot_ok = (ly < plan.win_y - plan.halo) | (geo.y0[by] + plan.win_y == ny)
    assert np.all(top_ok & bot_ok)
    assert np.all((lx >= plan.halo) & (lx < plan.win_x - plan.halo))
    assert gy.max() == ny - 1


@pytest.mark.parametrize("case", ["3d", "radius", "odd_periodic", "tiny",
                                  "offsets"])
def test_plan_declines(case):
    spec, _ = _problem(("extend", "periodic"), shape=(32, 32))
    shape = (64, 64)
    if case == "3d":
        spec = stencil.standard_3d(*(jnp.ones((5, 8, 8)),) * 3,
                                   jnp.zeros((5, 8, 8)),
                                   jnp.ones((5, 8, 8), bool), (1., 1., 1.),
                                   ("fixed", "fixed", "periodic"))
        shape = (5, 8, 8)
    elif case == "radius":
        import dataclasses
        spec = dataclasses.replace(spec, offsets=spec.offsets[:3] + ((0, 2),))
    elif case == "odd_periodic":
        shape = (64, 63)
    elif case == "tiny":
        shape = (6, 64)
    else:
        import dataclasses
        spec = dataclasses.replace(spec, offsets=((0, 1),) * 25)
    assert sor2d.window_plan(spec, shape) is None


@pytest.mark.parametrize("bih", [False, True])
def test_extend_blocks(bih):
    """Only windows holding the domain's first or last rows run the
    extend copies, and each copies from inside its own window."""
    spec, _ = _problem(("extend", "fixed"), shape=(64, 64), bih=bih)
    spec = stencil.prune_zero_offsets(spec)
    plan = sor2d.window_plan(spec, (64, 64), win_x=32, win_points=32 * 24)
    geo = sor2d.window_geometry(plan, 64, 64, spec.bcs, spec.bih)
    has = (geo.extend_src >= 0).any(axis=(1, 2))
    edge_rows = 2 if bih else 1
    touches = (geo.y0 < edge_rows) | (geo.y0 + plan.win_y > 64 - edge_rows)
    np.testing.assert_array_equal(has, touches)
    assert 0 < has.sum() < len(has)


def test_max_k_caps_sweeps_per_launch():
    spec, _ = _problem(("extend", "periodic"), shape=(32, 32))
    assert sor2d.window_plan(spec, (512, 512), max_k=1).k == 1
    assert sor2d.window_plan(spec, (512, 512), max_k=32).k == 4


# ---------------------------------------------------------------- dispatch

def _f32(spec):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a,
        spec)


@pytest.mark.parametrize("platform,dtype,scheme,kernel", [
    ("cpu", "f32", "sor", "xla"),
    ("gpu", "f32", "sor", "cuda"),
    ("gpu", "f64", "sor", "xla"),
    ("gpu", "f32", "lexico", "xla"),
    ("gpu", "f32", "cheby", "xla"),
    ("cpu", "f64", "sor", "xla"),
])
def test_dispatch_kernel(monkeypatch, platform, dtype, scheme, kernel):
    monkeypatch.setattr(solver, "_platform", lambda: platform)
    spec, S0 = _problem(("extend", "periodic"), shape=(64, 64))
    if dtype == "f32":
        spec, S0 = _f32(spec), S0.astype(jnp.float32)
    assert solver.choose_sweep(spec, S0, scheme).kernel == kernel


@pytest.mark.parametrize("platform,dtype,scheme,mx,cadence", [
    ("gpu", "f32", "sor", 5000, 32),
    ("gpu", "f32", "sor", 50, 5),
    ("gpu", "f32", "cheby", 5000, 32),
    ("gpu", "f32", "lexico", 5000, 1),
    ("gpu", "f64", "sor", 5000, 1),
    ("cpu", "f32", "sor", 5000, 1),
])
def test_dispatch_cadence(monkeypatch, platform, dtype, scheme, mx, cadence):
    monkeypatch.setattr(solver, "_platform", lambda: platform)
    spec, S0 = _problem(("extend", "periodic"), shape=(64, 64))
    if dtype == "f32":
        spec, S0 = _f32(spec), S0.astype(jnp.float32)
    assert solver.choose_sweep(spec, S0, scheme, mx).check_every == cadence


def test_dispatch_sharded_keeps_xla(monkeypatch):
    """GSPMD-sharded operands keep the partitionable XLA sweep."""
    from xinvert_tpu.parallel import make_grid_mesh, shard_problem
    monkeypatch.setattr(solver, "_platform", lambda: "gpu")
    spec, S0 = _problem(("extend", "periodic"), shape=(64, 64))
    spec, S0 = _f32(spec), S0.astype(jnp.float32)
    spec_sh, S_sh = shard_problem(spec, S0, make_grid_mesh(4))
    assert solver.choose_sweep(spec, S0).kernel == "cuda"
    assert solver.choose_sweep(spec_sh, S_sh).kernel == "xla"


def test_api_cadence_follows_dispatch(monkeypatch):
    from xinvert_tpu.models import api
    monkeypatch.setattr(solver, "_platform", lambda: "gpu")
    spec, S0 = _problem(("extend", "periodic"), shape=(64, 64))
    spec, S0 = _f32(spec), S0.astype(jnp.float32)
    iP = {"mxLoop": 400, "checkEvery": 1, "scheme": "sor"}
    assert api._auto_check_every(None, iP, spec, S0) == 32
    assert api._auto_check_every({"checkEvery": 1}, iP, spec, S0) == 1
    assert api._auto_check_every(None, dict(iP, scheme="lexico"),
                                 spec, S0) == 1


def test_use_kernel_true_raises_without_plan(monkeypatch):
    spec, S0 = _problem(("extend", "periodic"), shape=(64, 63))
    with pytest.raises(ValueError, match="use_kernel=True"):
        solver.solve_fixed(spec, S0, 1.5, 3, use_kernel=True)


# ---------------------------------------------------------------- solver path

def test_solve_fixed_through_kernel_path(kernel_on_cpu):
    spec, S0 = _problem(("extend", "periodic"), shape=(96, 128), batch=2)
    spec, S0 = _f32(spec), S0.astype(jnp.float32)
    assert solver.choose_sweep(spec, S0).kernel == "cuda"
    _close(solver.solve_fixed(spec, S0, 1.5, 13),
           solver.solve_fixed(spec, S0, 1.5, 13, use_kernel=False), 1e-5)


@pytest.mark.parametrize("check_every", [1, 8, 32])
def test_checked_solve_at_cap_through_kernel_path(kernel_on_cpu,
                                                  check_every):
    """tol=0: exactly max_iters sweeps (check windows of check_every,
    launches of plan.k, the remainder window in single-sweep launches)."""
    spec, S0 = _problem(("extend", "periodic"), shape=(96, 128), batch=2)
    spec, S0 = _f32(spec), S0.astype(jnp.float32)
    kw = dict(tol=0.0, max_iters=45, check_every=check_every)
    a = solver.solve(spec, S0, 1.5, **kw)
    b = solver.solve(spec, S0, 1.5, use_kernel=False, **kw)
    assert np.all(np.asarray(a.iters) == 45)
    _close(a.S, b.S, 1e-5)


def test_checked_solve_converges_like_xla(kernel_on_cpu):
    spec, S0 = _problem(("extend", "periodic"), shape=(64, 96))
    spec, S0 = _f32(spec), jnp.zeros((64, 96), jnp.float32)
    kw = dict(tol=1e-4, max_iters=4000, check_every=8)
    a = solver.solve(spec, S0, 1.8, **kw)
    b = solver.solve(spec, S0, 1.8, use_kernel=False, **kw)
    assert int(a.iters) == int(b.iters) < 4000
    _close(a.S, b.S, 1e-5)


def test_checked_solve_batched_freeze(kernel_on_cpu):
    """Per-slice stopping: a slice that converged keeps its state while
    the others sweep on."""
    spec, S0 = _problem(("fixed", "periodic"), shape=(64, 96), batch=3,
                        per_slice=True)
    spec = _f32(spec)
    S0 = jnp.zeros((3, 64, 96), jnp.float32)
    g = spec.g * jnp.asarray([1.0, 1e-3, 0.0], jnp.float32)[:, None, None]
    import dataclasses
    spec = dataclasses.replace(spec, g=g)
    kw = dict(tol=1e-3, max_iters=600, check_every=8)
    a = solver.solve(spec, S0, 1.8, **kw)
    b = solver.solve(spec, S0, 1.8, use_kernel=False, **kw)
    np.testing.assert_array_equal(np.asarray(a.iters), np.asarray(b.iters))
    _close(a.S, b.S, 1e-5)


def test_residual_rule_through_kernel_path(kernel_on_cpu):
    spec, S0 = _problem(("extend", "fixed"), shape=(64, 96))
    spec, S0 = _f32(spec), jnp.zeros((64, 96), jnp.float32)
    kw = dict(tol=1e-3, max_iters=2000, check_every=8, tol_type="residual")
    a = solver.solve(spec, S0, 1.8, **kw)
    b = solver.solve(spec, S0, 1.8, use_kernel=False, **kw)
    assert int(a.iters) == int(b.iters)
    _close(a.S, b.S, 1e-5)


def test_mg_smoothing_through_kernel_path(kernel_on_cpu):
    from xinvert_tpu.mg import build_pyramid_standard2d, solve_mg
    rng = np.random.default_rng(0)
    A = np.ones((64, 64), np.float32)
    F = rng.normal(0, 1, (64, 64)).astype(np.float32)
    Fdef = np.ones((64, 64), bool)
    Fdef[20:30, 10:30] = False
    with jax.enable_x64(False):
        pyr = build_pyramid_standard2d(A, 0.0, A, jnp.asarray(F), Fdef,
                                       (1.0, 1.0), ("fixed", "fixed"))
        S, k, res, ok = solve_mg(pyr, tol=1e-5, max_cycles=30)
    assert ok and res < 1e-5


def test_refine_through_kernel_path(kernel_on_cpu):
    from xinvert_tpu.refine import solve_refined
    spec, _ = _problem(("fixed", "periodic"), shape=(48, 64), mask=False)
    spec = _f32(spec)
    r = solve_refined(spec, jnp.zeros((48, 64), jnp.float32), omega=1.8,
                      tol=1e-6, max_rounds=6, inner_tol=1e-2,
                      inner_iters=2000)
    assert float(jnp.max(r.rel_residual)) <= 1e-6


# ---------------------------------------------------------------- FFI, build

def test_launch_cuda_forms_ffi_call(monkeypatch):
    """The FFI call the kernel path emits: operands (S, w, w0, g, rel) in
    the kernel's layouts and the plan as int32 attributes."""
    monkeypatch.setattr(cuda_build, "load_sor2d", lambda: None)
    spec, S0 = _problem(("extend", "periodic"), shape=(64, 96), batch=3)
    spec, S0 = _f32(spec), S0.astype(jnp.float32)
    plan = sor2d.window_plan(spec, S0.shape)
    planes = sor2d.prepare_planes(spec, S0.shape, 1.5)
    jaxpr = jax.make_jaxpr(lambda s: sor2d.launch_cuda(
        plan, spec, s, *planes, 3))(S0)
    eqn = [e for e in jaxpr.eqns if e.primitive.name == "ffi_call"][0]
    assert eqn.params["target_name"] == "xinvert_sor2d"
    shapes = [v.aval.shape for v in eqn.invars]
    assert shapes == [(3, 64, 96), (4, 1, 64, 96), (1, 64, 96),
                      (3, 64, 96), (1, 64, 96)]
    attrs = dict(eqn.params["attributes"])
    assert int(attrs["sweeps"]) == 3 and int(attrs["halo"]) == plan.halo
    assert int(attrs["extend_y"]) == 1 and int(attrs["periodic_x"]) == 1
    offs = getattr(attrs["offsets"], "val", attrs["offsets"])
    np.testing.assert_array_equal(np.asarray(offs).reshape(-1, 2),
                                  np.asarray(spec.offsets))


def test_build_command(monkeypatch, tmp_path):
    """nvcc builds for sm_90a without FMA contraction (so the kernel
    rounds as XLA's sweep does), into a source-hashed library name."""
    calls = []

    class Done:
        returncode = 0
        stderr = ""

    def fake_run(cmd, **kw):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "w").close()
        return Done()

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "run", fake_run)
    out = cuda_build.build()
    assert out.parent == tmp_path and out.name.startswith("libsor2d-")
    cmd = calls[0]
    assert "arch=compute_90a,code=sm_90a" in cmd and "--fmad=false" in cmd
    assert cuda_build.build() == out and len(calls) == 1


def test_build_fails_loudly(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(cuda_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(cuda_build.os.path, "isfile", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.nvcc()
