# -*- coding: utf-8 -*-
"""Device meshes and sharded solves (2-D spatial domain decomposition + data
parallelism over batch dims).

The scaling strategy replacing the reference's sequential slice loop
(/root/reference/xinvert/core.py:129-139) and its aspirational dask chunking
(README.md:35): the problem's arrays are placed with
``jax.sharding.NamedSharding`` over a ('batch', 'y', 'x') mesh and the jitted
solver runs unchanged — XLA's SPMD partitioner turns the stencil's
neighbor shifts into halo collective-permutes and the convergence norm into
a global all-reduce.  Works identically on one host and on several after
``jax.distributed.initialize``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..stencil import StencilSpec
from ..solver import solve, solve_fixed, SolveResult

__all__ = [
    "make_grid_mesh", "problem_pspecs", "shard_problem",
    "solve_sharded", "solve_fixed_sharded",
    "shard_mg_levels", "solve_mg_sharded",
]


def _factor2(n: int) -> Tuple[int, int]:
    """Split n into the most-square (a, b) with a*b == n, a <= b."""
    a = int(np.sqrt(n))
    while a > 1 and n % a:
        a -= 1
    return a, n // a


def make_grid_mesh(n_devices: Optional[int] = None, batch: int = 1,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A ('batch', 'y', 'x') mesh over the available devices.

    `batch` devices are assigned to data parallelism over non-core dims;
    the rest are factored near-square into the spatial ('y', 'x') axes so
    halo surface (and hence collective traffic) is minimised.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % batch:
        raise ValueError(f"batch axis {batch} does not divide {n} devices")
    ny, nx = _factor2(n // batch)
    arr = np.asarray(devices).reshape(batch, ny, nx)
    return Mesh(arr, ("batch", "y", "x"))


def problem_pspecs(spec: StencilSpec, batch_ndim: int):
    """PartitionSpecs for (spec, S) given the batch rank of the solution.

    Core dims map to the mesh spatial axes: the last dim to 'x', the
    second-to-last to 'y' (1-D problems shard over 'x' only).  Leading batch
    dims shard over 'batch'.  Spec arrays may or may not carry batch dims
    (g/w0 are batched when the forcing is); the weight stack's offset axis
    is replicated.
    """
    nd = spec.ndim
    core = ("x",) if nd == 1 else (None,) * (nd - 2) + ("y", "x")

    def lead_pspec(lead_rank, stacked=0):
        # `stacked` replicated axes first (the K offsets axis of w), then the
        # batch dims with the leading one sharded over 'batch'.
        lead = (None,) * stacked
        if lead_rank > 0 and batch_ndim > 0:
            lead = lead + ("batch",) + (None,) * (lead_rank - 1)
        else:
            lead = lead + (None,) * lead_rank
        return P(*(lead + core))

    def spec_pspec(a, stacked=0):
        return lead_pspec(a.ndim - nd - stacked, stacked)

    spec_specs = StencilSpec(
        w=spec_pspec(spec.w, stacked=1),
        w0=spec_pspec(spec.w0),
        g=spec_pspec(spec.g),
        relax=spec_pspec(spec.relax),
        active=spec_pspec(spec.active),
        offsets=spec.offsets, bcs=spec.bcs, bih=spec.bih,
        stop_on_zero_norm=spec.stop_on_zero_norm,
    )
    return spec_specs, lead_pspec(batch_ndim)


def shard_problem(spec: StencilSpec, S0, mesh: Mesh):
    """device_put the compiled problem and initial state onto the mesh.

    A dim the mesh axis does not divide stays replicated on that axis
    (:func:`_fit_pspec`); :func:`solve_sharded` pads the leading batch dim
    instead, so batches of any size still split over 'batch'."""
    batch_ndim = np.ndim(S0) - spec.ndim
    spec_specs, s_pspec = problem_pspecs(spec, batch_ndim)

    def put(a, p):
        return jax.device_put(a, NamedSharding(
            mesh, _fit_pspec(p, np.shape(a), mesh)))

    spec_sh = StencilSpec(
        w=put(spec.w, spec_specs.w), w0=put(spec.w0, spec_specs.w0),
        g=put(spec.g, spec_specs.g), relax=put(spec.relax, spec_specs.relax),
        active=put(spec.active, spec_specs.active),
        offsets=spec.offsets, bcs=spec.bcs, bih=spec.bih,
        stop_on_zero_norm=spec.stop_on_zero_norm,
    )
    S0_sh = put(S0, s_pspec)
    return spec_sh, S0_sh


def solve_sharded(spec: StencilSpec, S0, mesh: Optional[Mesh] = None,
                  omega: Optional[float] = None, tol: float = 1e-8,
                  max_iters: int = 5000, check_every: int = 1,
                  scheme: str = "sor",
                  tol_type: str = "change") -> SolveResult:
    """Convergence-checked solve with the problem sharded over `mesh`.

    Identical semantics to :func:`xinvert_tpu.solver.solve` (including the
    ``check_every`` / ``scheme`` / ``tol_type`` extensions); only placement
    differs.  The jitted driver inherits the input shardings — GSPMD inserts
    halo exchanges for the stencil shifts and a global reduction for the
    norm/termination test.
    """
    if mesh is None:
        mesh = make_grid_mesh()
    if omega is None:
        from ..grid import optimal_omega
        omega = optimal_omega(np.shape(S0)[-spec.ndim:])
    spec, S0, n_batch = _pad_batch(spec, S0, mesh)
    spec_sh, S0_sh = shard_problem(spec, S0, mesh)
    res = solve(spec_sh, S0_sh, omega=omega, tol=tol, max_iters=max_iters,
                check_every=check_every, scheme=scheme, tol_type=tol_type,
                use_kernel=False)
    if n_batch is None:
        return res
    return jax.tree_util.tree_map(lambda a: a[:n_batch], res)


def _pad_batch(spec: StencilSpec, S0, mesh: Mesh):
    """Pad the leading batch dim to a multiple of the mesh's 'batch' axis
    with copies of the last slice (spec planes batched like S0 included),
    so any batch splits over 'batch'.  A copy converges exactly like the
    slice it copies, so padding never extends the solve.  Returns
    ``(spec, S0, n)`` with ``n`` the original batch size, or None when
    nothing was padded."""
    S0 = jax.numpy.asarray(S0)
    nb = mesh.shape.get("batch", 1)
    if S0.ndim <= spec.ndim or S0.shape[0] % nb == 0:
        return spec, S0, None
    n = S0.shape[0]
    extra = nb - n % nb
    bnd = S0.ndim - spec.ndim

    def pad(a, lead=0):
        a = jax.numpy.asarray(a)
        if a.ndim - lead - spec.ndim != bnd or a.shape[lead] != n:
            return a                     # shared by all slices
        last = jax.lax.slice_in_dim(a, n - 1, n, axis=lead)
        reps = jax.numpy.repeat(last, extra, axis=lead)
        return jax.numpy.concatenate([a, reps], axis=lead)

    import dataclasses
    spec = dataclasses.replace(
        spec, w=pad(spec.w, 1), w0=pad(spec.w0), g=pad(spec.g),
        relax=pad(spec.relax), active=pad(spec.active))
    return spec, pad(S0), n


def _fit_pspec(p: P, shape, mesh: Mesh) -> P:
    """Drop mesh axes from a PartitionSpec on dims they do not divide.

    ``device_put`` requires even divisibility; multigrid pyramids have
    odd (vertex-coarsened) and small coarse dims, which simply replicate —
    the right distributed-MG behavior anyway (coarse grids are too small
    to be worth distributing)."""
    names = list(p) + [None] * (len(shape) - len(p))
    for i, (ax, n) in enumerate(zip(names, shape)):
        if ax is not None and n % mesh.shape[ax]:
            names[i] = None
    return P(*names)


def shard_mg_levels(levels, mesh: Mesh):
    """Place every multigrid level's arrays onto the mesh.

    Core dims shard like :func:`problem_pspecs` (rows over 'y', columns
    over 'x') wherever the mesh divides them; odd or small (coarse) dims
    replicate — the fine levels carry virtually all of the work anyway.
    Smoother choice and coarsening parity are static metadata stamped at
    build time, so the jitted V-cycle inherits the shardings unchanged
    (zebra line solves reshard their scan axis as needed).
    """
    import dataclasses

    def put(a, p):
        return jax.device_put(a, NamedSharding(mesh,
                                               _fit_pspec(p, a.shape, mesh)))

    out = []
    for lv in levels:
        sp = lv.spec
        pspecs, _ = problem_pspecs(sp, 0)
        spec_sh = StencilSpec(
            w=put(sp.w, pspecs.w), w0=put(sp.w0, pspecs.w0),
            g=put(sp.g, pspecs.g), relax=put(sp.relax, pspecs.relax),
            active=put(sp.active, pspecs.active),
            offsets=sp.offsets, bcs=sp.bcs, bih=sp.bih,
            stop_on_zero_norm=sp.stop_on_zero_norm,
        )
        out.append(dataclasses.replace(lv, spec=spec_sh,
                                       omega=put(lv.omega, P())))
    return out


def solve_mg_sharded(levels, S0=None, mesh: Optional[Mesh] = None,
                     g0=None, **kw):
    """:func:`xinvert_tpu.mg.solve_mg` with the pyramid sharded over
    ``mesh`` — same semantics, distributed placement.  ``S0``/``g0`` may
    carry a leading batch axis (sharded over the mesh 'batch' axis)."""
    from ..mg import solve_mg

    if mesh is None:
        mesh = make_grid_mesh()
    levels_sh = shard_mg_levels(levels, mesh)
    spec = levels[0].spec

    def put_state(a):
        if a is None:
            return None
        a = jax.numpy.asarray(a)
        _, p = problem_pspecs(spec, a.ndim - spec.ndim)
        return jax.device_put(a, NamedSharding(mesh,
                                               _fit_pspec(p, a.shape, mesh)))

    return solve_mg(levels_sh, put_state(S0), g0=put_state(g0), **kw)


def solve_fixed_sharded(spec: StencilSpec, S0, n_iters: int,
                        mesh: Optional[Mesh] = None,
                        omega: Optional[float] = None):
    """Fixed-iteration sharded solve (benchmark / parity hot path)."""
    if mesh is None:
        mesh = make_grid_mesh()
    if omega is None:
        from ..grid import optimal_omega
        omega = optimal_omega(np.shape(S0)[-spec.ndim:])
    spec_sh, S0_sh = shard_problem(spec, S0, mesh)
    return solve_fixed(spec_sh, S0_sh, omega, n_iters)
