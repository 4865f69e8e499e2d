# -*- coding: utf-8 -*-
"""Benchmark of the inversion path on an NVIDIA GPU.

    python bench.py

Prints one JSON line: {"metric", "value", "unit", "vs_baseline",
"device", "extras"}.  The headline is SOR grid-point updates per second
(grid points x sweeps / wall second) on the flagship masked spherical
Poisson at 2048^2, through ``solve_fixed`` as dispatched
(``solver.choose_sweep``).  Every time is host wall time around work that
ends in ``block_until_ready``, the median of repeated calls after a
warm-up call.  Without a GPU the script exits non-zero.

Baseline: the only wall-clock figure the reference publishes, the
QG-omega notebook (docs/source/notebooks/11_Omega_equation.ipynb, "time
used: 2920.08 s"): 4 inversions x 500 sweeps over a 37x72x288 grid on the
author's CPU = 767,232 pts x 2,000 sweeps / 2,920 s = 5.255e5
point-sweeps/s.

Extras, each naming what it compares:
- ``e2e_*``: a checked ``solve`` at the automatic check cadence, the
  dispatched sweep against the XLA sweep (``use_kernel=False``), on the
  2048^2 masked Poisson and on the 37 x 721 x 1440 batch;
- ``sweep3d_*``: the XLA sweep on 3-D volumes, with its model bytes/s
  (2 (K + 5) planes of 4 bytes per sweep: each half-sweep reads the state,
  K weights, g, w0 and the colour's relaxation plane and writes the state);
- ``omega3d``, ``bih2048``, ``mg``, ``refined``: the other solver paths.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

BASELINE_PTS_PER_S = 37 * 72 * 288 * 2000 / 2920.08


def _median_time(fn, reps=5):
    import jax
    jax.block_until_ready(fn())                       # compile + warm-up
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _f32(spec):
    import jax
    import jax.numpy as jnp
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.float64 else a,
        spec)


def _e2e(spec, S0, omega, mx=5000, tol=1e-6):
    """Checked solve at the automatic cadence: dispatched vs XLA."""
    from xinvert_tpu.solver import choose_sweep, solve
    choice = choose_sweep(spec, S0, "sor", mx)
    out = {"kernel": choice.kernel, "check_every": choice.check_every}
    for name, uk in (("dispatched", None), ("xla", False)):
        r = solve(spec, S0, omega, tol=tol, max_iters=mx,
                  check_every=choice.check_every, use_kernel=uk)
        out[f"{name}_s"] = _median_time(lambda: solve(
            spec, S0, omega, tol=tol, max_iters=mx,
            check_every=choice.check_every, use_kernel=uk).S, reps=3)
        out[f"{name}_iters_max"] = int(np.max(np.asarray(r.iters)))
    return out


def _sweep3d(shape, iters=100):
    """The XLA sweep on a 3-D omega-class volume, with model bytes/s."""
    import jax.numpy as jnp
    from xinvert_tpu import stencil
    from xinvert_tpu.solver import solve_fixed
    rng = np.random.default_rng(0)
    dt = np.float32
    A = ((np.abs(rng.normal(1.0, 0.1, shape)) + 0.5) * 2e-4).astype(dt)
    B = (np.abs(rng.normal(1.0, 0.1, shape)) + 0.5).astype(dt)
    F = rng.normal(0.0, 1e-12, shape).astype(dt)
    spec = stencil.standard_3d(jnp.asarray(A), jnp.asarray(B), jnp.asarray(B),
                               jnp.asarray(F), jnp.ones(shape, bool),
                               (5e3, 1.1e5, 1.0e5),
                               ("fixed", "extend", "periodic"))
    S0 = jnp.zeros(shape, dt)
    t = _median_time(lambda: solve_fixed(spec, S0, 1.4, iters))
    pts = int(np.prod(shape))
    K = len(spec.offsets)
    return {"ms": t * 1e3, "pt_sweeps_per_s": pts * iters / t,
            "model_bytes_per_s": 2 * (K + 5) * 4 * pts * iters / t}


def _bih(n=2048, iters=200):
    """The pruned Munk biharmonic stencil (radius 2), dispatched vs XLA."""
    import jax.numpy as jnp
    from xinvert_tpu import stencil
    from xinvert_tpu.solver import choose_sweep, solve_fixed
    rng = np.random.default_rng(0)
    dt = np.float32
    A4 = np.full((n, n), 5e3, dt)
    Z = np.zeros((n, n), dt)
    J = rng.normal(0, 1e-7, (n, n)).astype(dt)
    Fdef = np.ones((n, n), bool)
    Fdef[n // 3:n // 2, n // 4:n // 2] = False
    spec = stencil.general_2d_bih(
        *(jnp.asarray(a) for a in (A4, Z, A4, Z, Z, Z, Z,
                                   np.full((n, n), -2e-11, dt), Z, J)),
        jnp.asarray(Fdef), (5e4, 5e4), ("fixed", "fixed"))
    spec = stencil.prune_zero_offsets(spec)
    S0 = jnp.zeros((n, n), dt)
    out = {"kernel": choose_sweep(spec, S0).kernel,
           "offsets": len(spec.offsets)}
    for name, uk in (("dispatched", None), ("xla", False)):
        t = _median_time(lambda: solve_fixed(spec, S0, 1.0, iters,
                                             use_kernel=uk))
        out[f"{name}_pt_sweeps_per_s"] = n * n * iters / t
    return out


def _mg(n=2048):
    """Multigrid time to solution: masked Cartesian Poisson, FMG, to a
    relative residual of 1e-6."""
    import jax.numpy as jnp
    from xinvert_tpu.mg import build_pyramid_standard2d, solve_mg
    rng = np.random.default_rng(0)
    A = np.ones((n, n), np.float32)
    F = (rng.normal(0, 1, (n, n)) * 1e-9).astype(np.float32)
    Fdef = np.ones((n, n), bool)
    Fdef[n // 3:n // 2, n // 4:n // 2] = False
    pyr = build_pyramid_standard2d(A, 0.0, A, jnp.asarray(F), Fdef,
                                   (1.0e5, 1.0e5), ("fixed", "fixed"))
    S, k, res, ok = solve_mg(pyr, tol=1e-6, max_cycles=80, fmg=True)
    assert ok, f"MG did not converge: res={res:.2e}"
    t = _median_time(lambda: solve_mg(pyr, tol=1e-6, max_cycles=80,
                                      fmg=True)[0], reps=3)
    return {"ms": t * 1e3, "cycles": int(k), "residual": float(res)}


def _refined(n=2048):
    """Certified refinement on the full-sphere problem, shallow rounds."""
    import jax.numpy as jnp
    from __graft_entry__ import _poisson_problem
    from xinvert_tpu.refine import solve_refined
    spec, S0, grid = _poisson_problem(batch=0, ny=n, nx=n, dtype=np.float32)
    kw = dict(omega=grid.omega_opt, tol=1e-5, max_rounds=10, inner_tol=1.0,
              inner_iters=4000)
    r = solve_refined(spec, S0, **kw)
    rel = float(jnp.max(r.rel_residual))
    assert rel <= 1e-5, f"certification missed: {rel:.2e}"
    t = _median_time(lambda: solve_refined(spec, S0, **kw).S_hi, reps=3)
    return {"s": t, "rel_residual": rel, "rounds": r.rounds}


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench: no GPU (JAX found {devs[0].platform})",
              file=sys.stderr)
        return 3
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    from xinvert_tpu import enable_compile_cache
    enable_compile_cache()
    from __graft_entry__ import _poisson_problem
    from xinvert_tpu.solver import solve_fixed

    ny = nx = 2048
    iters = 500
    spec, S0, grid = _poisson_problem(batch=0, ny=ny, nx=nx,
                                      dtype=np.float32)
    omega = grid.omega_opt
    t = _median_time(lambda: solve_fixed(spec, S0, omega, iters))
    pts_per_s = ny * nx * iters / t

    extras = {"e2e_2048": _e2e(spec, S0, omega)}
    specb, S0b, gridb = _poisson_problem(batch=37, ny=721, nx=1440,
                                         dtype=np.float32)
    extras["e2e_37x721x1440"] = _e2e(specb, S0b, gridb.omega_opt)
    del specb, S0b
    for shape in ((73, 72, 288), (30, 330, 720)):
        extras["sweep3d_" + "x".join(map(str, shape))] = _sweep3d(shape)
    om3 = _sweep3d((37, 72, 288), iters=500)
    extras["omega3d_37x72x288_500sweeps_ms"] = om3["ms"]
    extras["bih2048"] = _bih()
    extras["mg_fmg_2048"] = _mg()
    extras["refined_2048"] = _refined()

    print(json.dumps({
        "metric": "masked_poisson_sor_point_sweeps_per_s",
        "value": pts_per_s,
        "unit": "grid-point-sweeps/s",
        "vs_baseline": pts_per_s / BASELINE_PTS_PER_S,
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs),
                   "card": card},
        "extras": extras,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
