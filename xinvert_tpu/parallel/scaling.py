# -*- coding: utf-8 -*-
"""Multi-host entry and the scaling-efficiency harness.

The BASELINE north star is >= 85% scaling efficiency from 1 chip to 1 host
to N hosts.  This module provides

- :func:`initialize_distributed` — the ``jax.distributed.initialize``
  wrapper for multi-host runs (no-op when single-process or already
  initialised);
- :func:`make_hybrid_mesh` — a ('batch', 'y', 'x') mesh whose batch/data
  axis, whose traffic is zero during a solve, spans the hosts, while the
  stencil's halo exchanges and the convergence all-reduce stay inside one;
- :func:`scaling_bench` — one command producing the BASELINE efficiency
  table: per-device throughput vs device count for the flagship masked
  spherical Poisson at a fixed per-device problem size (weak scaling) or a
  fixed global size (strong scaling), on whatever devices exist.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp

from .mesh import make_grid_mesh, shard_problem

__all__ = ["initialize_distributed", "make_hybrid_mesh", "scaling_bench",
           "format_scaling_table"]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> bool:
    """Initialise the multi-host JAX runtime.  Returns True when a
    multi-process runtime is active after the call.

    Pass the coordinator address (``host:port``), the process count and
    this process's id (the ``jax.distributed.initialize`` contract).  Safe
    to call repeatedly and in single-process runs.
    """
    if jax.process_count() > 1:
        return True
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except (RuntimeError, ValueError):
        # already initialised, or single-process with no coordinator: the
        # single-host path needs no runtime
        pass
    return jax.process_count() > 1


def make_hybrid_mesh(batch: int = 1, devices: Optional[Sequence] = None):
    """A ('batch', 'y', 'x') mesh whose 'batch' axis runs across processes.

    Per-sweep halo exchange and the convergence norm are the only
    communication in a solve; ordering the devices by process before the
    (batch, y, x) reshape keeps each grid replica (batch member) inside one
    host, so a solve sends nothing between hosts until results are
    gathered.  On one host this is :func:`make_grid_mesh`.
    """
    if devices is None:
        devices = jax.devices()
    devices = sorted(devices, key=lambda d: (d.process_index, d.id))
    return make_grid_mesh(batch=batch, devices=devices)


def _bench_once(spec, S0, mesh, omega, n_iters, reps=3,
                executor="gspmd", k_sweeps=1):
    """Median wall time of a fixed-iteration sharded solve, each run timed
    to ``block_until_ready``.

    ``executor='gspmd'`` lets the partitioner derive the halo traffic from
    sharding annotations; ``'halo'`` uses the explicit ppermute executor
    (``k_sweeps>1`` for its communication-avoiding mode)."""
    if executor == "gspmd":
        from ..solver import solve_fixed
        spec_sh, S_sh = shard_problem(spec, S0, mesh)
        fn = lambda s: solve_fixed(spec_sh, s, omega, n_iters)
    elif executor == "halo":
        from .halo import solve_fixed_halo
        S_sh = S0
        fn = lambda s: solve_fixed_halo(spec, s, omega, n_iters,
                                        mesh=mesh, k_sweeps=k_sweeps)
    else:
        raise ValueError(f"unknown executor {executor!r}")
    jax.block_until_ready(fn(S_sh))            # compile
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(S_sh))
        times.append(time.perf_counter() - t0)
    assert np.isfinite(np.asarray(out)).all()
    return float(np.median(times))


def scaling_bench(device_counts: Optional[Sequence[int]] = None,
                  base_ny: int = 256, base_nx: int = 256,
                  n_iters: int = 50, mode: str = "weak",
                  dtype=None, executor: str = "gspmd", k_sweeps: int = 1):
    """Throughput vs device count for the flagship masked Poisson.

    ``mode='weak'``: the grid grows with the device count (fixed per-device
    work) — efficiency = per-device throughput / single-device throughput.
    ``mode='strong'``: the global grid is fixed at (base_ny, base_nx).

    Returns a list of row dicts (the BASELINE efficiency-table schema):
    ``{'devices', 'mesh', 'grid', 'pts_per_s', 'pts_per_s_per_device',
    'efficiency'}``.
    """
    import sys
    sys.path.insert(0, __file__.rsplit("/xinvert_tpu/", 1)[0])
    from __graft_entry__ import _poisson_problem

    if dtype is None:
        dtype = np.float64 if jax.config.jax_enable_x64 else np.float32
    if device_counts is None:
        n = jax.device_count()
        device_counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= n]

    rows = []
    base_rate = None
    for c in device_counts:
        mesh = make_grid_mesh(n_devices=c)      # near-square ('y', 'x')
        my_, mx_ = mesh.shape["y"], mesh.shape["x"]
        if mode == "weak":
            ny, nx = base_ny * my_, base_nx * mx_
        else:
            ny, nx = base_ny, base_nx
        if ny % my_ or nx % mx_:
            continue
        spec, S0, grid = _poisson_problem(batch=0, ny=ny, nx=nx,
                                          dtype=dtype)
        dt = _bench_once(spec, S0, mesh, grid.omega_opt, n_iters,
                         executor=executor, k_sweeps=k_sweeps)
        pts0 = ny * nx
        pts = pts0 * n_iters / dt
        per_dev = pts / c
        if base_rate is None:
            base_rate = per_dev
        rows.append({
            "devices": c,
            "mesh": f"{my_}x{mx_}",
            "grid": f"{ny}x{nx}",
            "pts_per_s": pts,
            "pts_per_s_per_device": per_dev,
            "efficiency": per_dev / base_rate,
        })
    return rows


def format_scaling_table(rows) -> str:
    head = (f"{'devices':>8} {'mesh':>6} {'grid':>12} "
            f"{'pt-sweeps/s':>12} {'per-device':>12} {'eff':>6}")
    lines = [head]
    for r in rows:
        lines.append(f"{r['devices']:>8} {r['mesh']:>6} {r['grid']:>12} "
                     f"{r['pts_per_s']:>12.3e} "
                     f"{r['pts_per_s_per_device']:>12.3e} "
                     f"{r['efficiency']:>6.2f}")
    return "\n".join(lines)


if __name__ == "__main__":
    rows = scaling_bench()
    print(format_scaling_table(rows))
