#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""Smoke run of the inversion path on an NVIDIA GPU.

    python chip_smoke.py [--seed N]     # one card: phases 1-7 below
    python chip_smoke.py --four         # four cards: the mesh path only

Phases (one card), each at a size users run, with every field built from
``--seed`` in numpy (no data files):

1. flagship: ``invert_Poisson`` on a 2048 x 2048 masked lat-lon grid,
   f32, BCs (extend, periodic), at the automatic check cadence and at
   ``checkEvery=1``; then the dispatched sweep (the fused CUDA kernel)
   against the XLA sweep at 500 sweeps;
2. reanalysis batch: ``invert_Poisson`` on 37 levels x 721 x 1440 (ERA5's
   0.25-degree pressure-level grid); dispatched vs XLA sweep at 200 sweeps;
3. 3-D omega: ``invert_omega`` at 37 x 72 x 288, 500 sweeps, f32 against
   the same call in float64;
4. ``scheme="direct"`` on an unmasked 2048^2 global Poisson, f32 against
   float64;
5. ``tolType="refined"``-class certified refinement at 2048^2;
6. ``invert_Poisson_mg`` on a 2048^2 masked Cartesian grid;
7. the ``chip``-marked tests, in this process.

Each phase prints one line: shapes, first-call and steady times, its error
against its reference, and the bound and precision it is held to.  Any
failure exits non-zero.  The last two lines are the card's name and power
limit (``nvidia-smi``) and one JSON object naming the device.  Without a
GPU, or without the package beside it, the script exits non-zero and
prints no result.
"""
import argparse
import json
import os
import subprocess
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cuda")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

ERA5 = (37, 721, 1440)


def card_line() -> str:
    """Name and power limit of the card, read by a child that stays off
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


class x64:
    """Run a block with float64 enabled (the API's dtype follows it)."""

    def __enter__(self):
        import jax
        self.old = jax.config.jax_enable_x64
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        import jax
        jax.config.update("jax_enable_x64", self.old)


def timed(fn):
    """(result, first-call seconds, steady seconds): two calls, each to
    block_until_ready."""
    import jax
    out = []
    for _ in range(2):
        t0 = time.perf_counter()
        r = jax.block_until_ready(fn())
        out.append(time.perf_counter() - t0)
    return r, out[0], out[1]


def rel_err(a, ref) -> float:
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.nanmax(np.abs(a - ref)) / np.nanmax(np.abs(ref)))


def report(name, shape, t_first, t_steady, err, bound, precision, extra=""):
    ok = err <= bound
    print(f"[{name}] shape={shape} first={t_first:.3f}s "
          f"steady={t_steady:.3f}s err={err:.3e} bound={bound:.0e} "
          f"({precision}) {'ok' if ok else 'FAILED'}{extra}", flush=True)
    if not ok:
        raise SystemExit(f"phase {name}: error {err:.3e} above {bound:.0e}")


# ---------------------------------------------------------------- problems

def latlon_field(shape, seed, masked=True):
    """Vorticity-like forcing on a global lat-lon grid, NaN on a
    continent-like mask (the reference's undef convention)."""
    from xinvert_tpu import Field
    ny, nx = shape[-2:]
    lat = np.linspace(-89.75, 89.75, ny) if ny % 2 else \
        np.linspace(-90 + 90.0 / ny, 90 - 90.0 / ny, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    rng = np.random.default_rng(seed)
    L = np.deg2rad(lat)[:, None]
    Lo = np.deg2rad(lon)[None, :]
    base = (np.sin(3 * Lo) * np.cos(2 * L)) * 1e-5
    vor = base + 1e-6 * rng.standard_normal(shape)
    if masked:
        land = ((np.abs(L - 0.3) < 0.35) & (np.abs(Lo - 1.2) < 0.6)) | \
            ((np.abs(L + 0.5) < 0.25) & (np.abs(Lo - 4.0) < 0.4))
        vor = np.where(land, np.nan, vor)
    dims = ("lat", "lon") if len(shape) == 2 else ("level", "lat", "lon")
    coords = {"lat": lat, "lon": lon}
    if len(shape) == 3:
        coords["level"] = np.arange(shape[0], dtype=np.float64)
    return Field(vor.astype(np.float32), dims, coords)


def spec_of(field, bcs):
    """The compiled StencilSpec and initial state the API builds for
    ``invert_Poisson`` on ``field`` (same builder, same mask)."""
    import jax.numpy as jnp
    from xinvert_tpu.grid import Grid
    from xinvert_tpu.models import problems
    from xinvert_tpu.models.params import default_mParams
    vals = np.asarray(field.values)
    Fdef = ~np.isnan(vals)
    while Fdef.ndim > 2:
        Fdef = Fdef.all(axis=0)
    grid = Grid.make(("lat", "lon"), (field.coords["lat"],
                                      field.coords["lon"]), "lat-lon", bcs)
    spec = problems.build_poisson(jnp.asarray(np.nan_to_num(vals)),
                                  jnp.asarray(Fdef), grid, default_mParams)
    return spec, jnp.zeros(vals.shape, vals.dtype), grid


def residual64(spec, S):
    """Relative residual mean|r| / mean|g| over active cells, in float64
    numpy on the host (information only)."""
    S = np.asarray(S, np.float64)
    w = np.asarray(spec.w, np.float64)
    r = np.asarray(spec.g, np.float64) + np.asarray(spec.w0, np.float64) * S
    for k, off in enumerate(spec.offsets):
        r = r + w[k] * np.roll(S, tuple(-o for o in off), axis=(-2, -1))
    act = np.asarray(spec.active)
    return float(np.abs(np.where(act, r, 0)).sum()
                 / np.abs(np.where(act, np.asarray(spec.g, np.float64),
                                   0)).sum())


# ---------------------------------------------------------------- phases

IP = {"BCs": ["extend", "periodic"], "undef": np.nan, "printInfo": False}


def phase_flagship(seed, n=(2048, 2048), mx=5000, fixed=500):
    from xinvert_tpu import invert_Poisson
    from xinvert_tpu.models import api
    from xinvert_tpu.solver import choose_sweep, solve_fixed
    F = latlon_field(n, seed)
    spec, S0, grid = spec_of(F, ("extend", "periodic"))
    lines = []
    for ce in (None, 1):
        ip = dict(IP, mxLoop=mx, tolerance=1e-6)
        if ce:
            ip["checkEvery"] = ce
        out, t1, t2 = timed(lambda: invert_Poisson(
            F, dims=["lat", "lon"], iParams=ip).values)
        r = api.LAST_SOLVE
        lines.append(f"checkEvery={ce or 'auto'}: loops "
                     f"{int(np.asarray(r.iters))} rel change "
                     f"{float(np.asarray(r.rel_change)):.3e} "
                     f"first {t1:.3f}s steady {t2:.3f}s")
        sol = out
    print("[flagship] " + " | ".join(lines), flush=True)
    assert np.isfinite(np.nan_to_num(sol)).all()
    kern = choose_sweep(spec, S0).kernel
    om = grid.omega_opt
    out, t1, t2 = timed(lambda: solve_fixed(spec, S0, om, fixed))
    ref, r1, r2 = timed(lambda: solve_fixed(spec, S0, om, fixed,
                                            use_kernel=False))
    res = residual64(spec, np.nan_to_num(sol))
    report("flagship-sweep", tuple(n), t1, t2, rel_err(out, ref), 1e-5,
           "f32", f" dispatched={kern} xla first={r1:.3f}s "
           f"steady={r2:.3f}s sweeps={fixed} host-f64 residual of the "
           f"solve={res:.3e} (f32 floor, information only)")


def phase_batch(seed, shape=ERA5, mx=5000, fixed=200):
    from xinvert_tpu import invert_Poisson
    from xinvert_tpu.models import api
    from xinvert_tpu.solver import choose_sweep, solve_fixed
    F = latlon_field(shape, seed + 1)
    spec, S0, grid = spec_of(F, ("extend", "periodic"))
    ip = dict(IP, mxLoop=mx, tolerance=1e-6)
    _, t1, t2 = timed(lambda: invert_Poisson(
        F, dims=["lat", "lon"], iParams=ip).values)
    loops = np.asarray(api.LAST_SOLVE.iters).ravel()
    kern = choose_sweep(spec, S0).kernel
    om = grid.omega_opt
    out, k1, k2 = timed(lambda: solve_fixed(spec, S0, om, fixed))
    ref, r1, r2 = timed(lambda: solve_fixed(spec, S0, om, fixed,
                                            use_kernel=False))
    report("batch", tuple(shape), t1, t2, rel_err(out, ref), 1e-5, "f32",
           f" per-slice loops min/median/max={loops.min()}/"
           f"{int(np.median(loops))}/{loops.max()} dispatched={kern} "
           f"sweeps={fixed} kernel steady={k2:.3f}s xla steady={r2:.3f}s")


def omega_field(shape, seed):
    from xinvert_tpu import Field
    nz, ny, nx = shape
    lev = np.linspace(100000.0, 10000.0, nz)
    lat = np.linspace(-87.5, 87.5, ny)
    lon = np.linspace(0.0, 360.0 - 360.0 / nx, nx)
    rng = np.random.default_rng(seed)
    L = np.deg2rad(lat)[None, :, None]
    Lo = np.deg2rad(lon)[None, None, :]
    env = np.exp(-((np.abs(L) - np.deg2rad(45)) / np.deg2rad(15)) ** 2)
    vert = np.sin(np.pi * (100000.0 - lev[:, None, None]) / 90000.0)
    F = np.zeros(shape)
    for k in range(4, 9):
        F += rng.normal() * np.sin(k * Lo + rng.uniform(0, 6)) * env \
            * vert / k
    N2 = np.where(lev > 25000.0, 1.5e-5, 6e-5)
    coords = {"LEV": lev, "lat": lat, "lon": lon}
    return (Field(F * 1e-15, ("LEV", "lat", "lon"), coords),
            Field(N2, ("LEV",), {"LEV": lev}))


def phase_omega(seed, shape=(37, 72, 288), sweeps=500):
    from xinvert_tpu import invert_omega
    F, N2 = omega_field(shape, seed + 2)
    ip = {"BCs": ["fixed", "fixed", "periodic"], "tolerance": 0.0,
          "mxLoop": sweeps, "printInfo": False}

    def run():
        return invert_omega(F, dims=["LEV", "lat", "lon"], iParams=ip,
                            mParams={"N2": N2}).values

    out, t1, t2 = timed(run)
    with x64():
        ref = run()
    assert out.dtype == np.float32 and ref.dtype == np.float64
    report("omega3d", tuple(shape), t1, t2, rel_err(out, ref), 1e-4,
           "f32 vs f64 on the card", f" sweeps={sweeps}")


def phase_direct(seed, n=(2048, 2048)):
    """scheme='direct', f32 against f64.  The f32 solve's forward error is
    bounded by conditioning, eps * cond, and the Poisson operator's
    condition number grows like n^2: on the CPU the f32-vs-f64 difference
    is 3e-6 at 64 x 96, 7e-5 at 256 x 512, 8e-3 at 1024 x 2048 and 2.3e-2
    at 2048^2, with or without TF32.  So this phase reports that number
    against the 1e-4 bound and fails on what would make it worse on a GPU:
    the transform matmul must run at full float32 precision (TF32, about
    three digits, would put it near 1e-3)."""
    import jax
    import jax.numpy as jnp
    from xinvert_tpu import invert_Poisson
    from xinvert_tpu.models import api
    from xinvert_tpu.ops.direct import _mm
    F = latlon_field(n, seed + 3, masked=False)
    # Dirichlet rows at the grid's first and last latitudes: with extend
    # rows (zero gradient) and periodic x the operator would be singular
    # and the two precisions would pick different constants
    ip = dict(IP, scheme="direct", BCs=["fixed", "periodic"])

    def run():
        return invert_Poisson(F, dims=["lat", "lon"], iParams=ip).values

    out, t1, t2 = timed(run)
    res32 = float(np.asarray(api.LAST_SOLVE.rel_change))
    with x64():
        ref = run()
        res64 = float(np.asarray(api.LAST_SOLVE.rel_change))
    err = rel_err(out, ref)
    print(f"[direct] shape={tuple(n)} first={t1:.3f}s steady={t2:.3f}s "
          f"err={err:.3e} bound=1e-04 (f32 vs f64 on the card) "
          f"{'ok' if err <= 1e-4 else 'MISSED: f32 conditioning bound'} "
          f"residual f32={res32:.3e} f64={res64:.3e}", flush=True)
    rng = np.random.default_rng(seed + 7)
    a = rng.standard_normal((n[0], n[1])).astype(np.float32)
    q = rng.standard_normal((n[1], n[1])).astype(np.float32)
    mm, m1, m2 = timed(lambda: jax.jit(_mm)(jnp.asarray(a), jnp.asarray(q)))
    exact = a.astype(np.float64) @ q.astype(np.float64)
    report("direct-matmul", (n[0], n[1], n[1]), m1, m2,
           rel_err(mm, exact), 1e-5, "f32 HIGHEST vs f64 numpy")


def phase_refined(seed, n=(2048, 2048)):
    """Certified refinement on the benchmark's full-sphere problem
    (__graft_entry__._poisson_problem: masked, latitudes to +-88.75) with
    shallow rounds: 10 rounds of at most 4000 inner sweeps."""
    import jax.numpy as jnp
    from __graft_entry__ import _poisson_problem
    from xinvert_tpu.refine import solve_refined
    spec, S0, grid = _poisson_problem(batch=0, ny=n[0], nx=n[1],
                                      dtype=np.float32)

    def run():
        r = solve_refined(spec, S0, omega=grid.omega_opt, tol=1e-5,
                          max_rounds=10, inner_tol=1.0, inner_iters=4000)
        return r.S_hi, r.rel_residual, r.rounds

    (S, rel, rounds), t1, t2 = timed(run)
    report("refined", tuple(n), t1, t2, float(jnp.max(rel)), 1e-5,
           "certified double-f32 relative residual",
           f" rounds={rounds}")


def phase_mg(seed, n=(2048, 2048)):
    from xinvert_tpu import Field, invert_Poisson_mg
    from xinvert_tpu.models import api
    ny, nx = n
    rng = np.random.default_rng(seed + 5)
    F = rng.normal(0, 1, n) * 1e-9
    F[ny // 3:ny // 2, nx // 4:nx // 2] = np.nan
    y = np.arange(ny) * 1.0e5
    x = np.arange(nx) * 1.0e5
    Ff = Field(F.astype(np.float32), ("y", "x"), {"y": y, "x": x})
    ip = {"BCs": ["fixed", "fixed"], "undef": np.nan, "printInfo": False}

    def run():
        return invert_Poisson_mg(Ff, dims=["y", "x"], coords="cartesian",
                                 iParams=ip, tol=1e-6,
                                 max_cycles=80).values

    _, t1, t2 = timed(run)
    r = api.LAST_SOLVE
    report("mg", tuple(n), t1, t2, float(np.asarray(r.rel_change)), 1e-6,
           "f32 max-residual / max|g|", f" cycles={int(np.asarray(r.iters))}")


def phase_chip_tests():
    import pytest
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "chip", "-p", "no:cacheprovider",
                      "-p", "no:randomly",
                      os.path.join(HERE, "tests", "test_chip.py")])
    print(f"[chip-tests] exit={int(rc)} {time.perf_counter() - t0:.1f}s",
          flush=True)
    if rc != 0:
        raise SystemExit(f"chip tests failed (pytest exit {int(rc)})")


# ---------------------------------------------------------------- four cards

def phase_four(seed, shape=ERA5, grid2=(4096, 4096), sweeps=200):
    """The mesh path users reach through iParams['mesh'] on four cards,
    each solve against the one-card result at a fixed sweep count."""
    import jax
    from jax.sharding import Mesh
    from xinvert_tpu import invert_Poisson
    devs = np.asarray(jax.devices()[:4])
    if devs.size < 4:
        raise SystemExit(f"--four needs 4 devices, found {devs.size}")
    ip = dict(IP, tolerance=0.0, mxLoop=sweeps)
    cases = [("four-batch", latlon_field(shape, seed + 1),
              Mesh(devs.reshape(4, 1, 1), ("batch", "y", "x"))),
             ("four-y", latlon_field(grid2, seed + 6),
              Mesh(devs.reshape(1, 4, 1), ("batch", "y", "x")))]
    for name, F, mesh in cases:
        one, o1, o2 = timed(lambda: invert_Poisson(
            F, dims=["lat", "lon"], iParams=ip).values)
        four, t1, t2 = timed(lambda: invert_Poisson(
            F, dims=["lat", "lon"], iParams=dict(ip, mesh=mesh)).values)
        report(name, tuple(F.shape), t1, t2, rel_err(four, one), 1e-6,
               "f32, 4 cards vs 1 card",
               f" mesh={dict(mesh.shape)} sweeps={sweeps} one-card "
               f"steady={o2:.3f}s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh path")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform})",
              file=sys.stderr)
        return 3
    card = card_line()
    from xinvert_tpu import enable_compile_cache
    enable_compile_cache()
    t0 = time.perf_counter()
    if args.four:
        phase_four(args.seed)
    else:
        phase_flagship(args.seed)
        phase_batch(args.seed)
        phase_omega(args.seed)
        phase_direct(args.seed)
        phase_refined(args.seed)
        phase_mg(args.seed)
        phase_chip_tests()
    print(f"[total] {time.perf_counter() - t0:.1f}s", flush=True)
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
