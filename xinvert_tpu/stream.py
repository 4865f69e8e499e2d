# -*- coding: utf-8 -*-
"""Host-streaming batch executor: solve batch dims larger than HBM.

The reference's README claims dask-chunked application over big datasets
(/root/reference/README.md:35) but its solvers are per-slice numba loops; the
batched path (core.py) instead vectorises every non-core dim into one
device program — which requires the whole batch (forcing, coefficients and
state) to fit HBM at once.  This module closes that gap (SURVEY §2.4
out-of-core): the batch stays in HOST memory and streams through the device
in fixed-size chunks, double-buffered so the H2D transfer of chunk k+1 and
the D2H fetch of chunk k-1 overlap the solve of chunk k.

All three queues (H2D copy, compute, D2H copy) are driven by JAX's async
dispatch: ``jax.device_put`` returns immediately, the jitted solve is
enqueued behind it, and ``copy_to_host_async`` enqueues the fetch behind the
solve — the Python loop never blocks until it touches the chunk *behind* the
one in flight.  Batch elements are independent in the solver (per-element
convergence flags, SolveResult telemetry), so the chunked result is
bit-identical to the resident batched solve; the last chunk is padded by
repeating its final slice to keep every launch the same shape (one
compile).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .solver import SolveResult, solve
from .stencil import StencilSpec

__all__ = ["solve_streamed"]


# spec data fields and the axis their (optional) batch dim occupies after
# flattening: w is (K, B?, *grid), the rest (B?, *grid)
_FIELDS = (("w", 1), ("w0", 0), ("g", 0), ("relax", 0), ("active", 0))


def _flat_np(a, lead, core):
    """Collapse multi-dim batch to one axis, on host (numpy view)."""
    a = np.asarray(a)
    if a.ndim > lead + core + 1:
        return a.reshape(a.shape[:lead] + (-1,) + a.shape[a.ndim - core:])
    return a


def _chunk_np(a, lead, core, B, b0, nb, pad_to):
    """Host-side batch slice [b0:b0+nb], edge-padded to ``pad_to`` rows.

    Returns None when the field carries no batch (shared across chunks)."""
    if a.ndim <= lead + core or a.shape[lead] != B:
        return None
    sl = (slice(None),) * lead + (slice(b0, b0 + nb),)
    part = a[sl]
    if nb < pad_to:
        last = a[(slice(None),) * lead + (slice(b0 + nb - 1, b0 + nb),)]
        reps = [1] * a.ndim
        reps[lead] = pad_to - nb
        part = np.concatenate([part, np.tile(last, reps)], axis=lead)
    return part


def solve_streamed(spec: StencilSpec, S0, omega=None, tol: float = 1e-8,
                   max_iters: int = 5000, *, chunk: int,
                   check_every: int = 1, scheme: str = "sor",
                   tol_type: str = "change", device=None) -> SolveResult:
    """Chunked out-of-core batched solve; bit-identical to :func:`solve`.

    ``spec`` arrays and ``S0`` should live in host memory (numpy); batch
    dims follow the batched-solve contract (one leading batch axis after
    flattening, or broadcast/absent for shared fields).  ``chunk`` is the
    number of batch slices resident on the device at a time — choose it so
    roughly ``3 * chunk`` slices of state + coefficients fit HBM (two
    chunks are in flight plus the one being fetched).

    Returns a :class:`SolveResult` whose arrays are host numpy arrays with
    the input batch shape.
    """
    core = spec.ndim
    S0 = np.asarray(S0)
    grid = S0.shape[S0.ndim - core:]
    s_batch = S0.shape[:S0.ndim - core]
    # the solve's batch shape is the broadcast of the state's and every
    # spec field's batch dims (matching the resident batched path, where
    # the sweep broadcasts them together)
    batch_shape = np.broadcast_shapes(
        s_batch, *(np.shape(getattr(spec, n))[lead:
                                              np.ndim(getattr(spec, n))
                                              - core]
                   for n, lead in _FIELDS))
    B = int(np.prod(batch_shape, dtype=np.int64)) if batch_shape else 1
    if device is None:
        device = jax.devices()[0]

    if B <= chunk:
        # fits in one resident chunk: ordinary batched solve, untouched
        # spec shapes (no flattening needed)
        S0b = np.broadcast_to(S0, batch_shape + grid)
        r = solve(spec, jax.device_put(jnp.asarray(S0b), device), omega,
                  tol=tol, max_iters=max_iters, check_every=check_every,
                  scheme=scheme, tol_type=tol_type)
        return SolveResult(
            S=np.asarray(r.S), iters=np.asarray(r.iters),
            rel_change=np.asarray(r.rel_change),
            overflow=np.asarray(r.overflow))

    fields = {n: _flat_np(getattr(spec, n), lead, core)
              for n, lead in _FIELDS}
    if s_batch == batch_shape and batch_shape:
        S0 = S0.reshape((B,) + grid)
    elif s_batch not in ((), batch_shape):
        # partially-broadcast state: materialise the full flat batch once
        # (host memory; the common streaming cases above avoid this copy)
        S0 = np.ascontiguousarray(
            np.broadcast_to(S0, batch_shape + grid)).reshape((B,) + grid)

    # shared (unbatched) fields go to the device once
    shared = {}
    for n, lead in _FIELDS:
        a = fields[n]
        if a.ndim <= lead + core or a.shape[lead] != B:
            shared[n] = jax.device_put(jnp.asarray(a), device)
    S0_shared = None
    if not s_batch:
        # unbatched initial state: materialise one (chunk, *grid) copy
        S0_shared = jax.device_put(
            jnp.broadcast_to(jnp.asarray(S0), (chunk,) + grid), device)

    n_chunks = -(-B // chunk)

    def put_chunk(i):
        b0 = i * chunk
        nb = min(chunk, B - b0)
        parts = {}
        for n, lead in _FIELDS:
            if n in shared:
                parts[n] = shared[n]
            else:
                parts[n] = jax.device_put(
                    jnp.asarray(_chunk_np(fields[n], lead, core, B,
                                          b0, nb, chunk)), device)
        cspec = dataclasses.replace(spec, **parts)
        if S0_shared is not None:
            Sc = S0_shared
        else:
            Sc = jax.device_put(
                jnp.asarray(_chunk_np(S0, 0, core, B, b0, nb, chunk)),
                device)
        return nb, cspec, Sc

    out_S = np.empty((B,) + grid, S0.dtype)
    out_it = np.empty((B,), np.int32)
    out_rel = np.empty((B,), S0.dtype)
    out_ovf = np.empty((B,), bool)

    def fetch(i, nb, r):
        b0 = i * chunk
        out_S[b0:b0 + nb] = np.asarray(r.S)[:nb]
        out_it[b0:b0 + nb] = np.asarray(r.iters)[:nb]
        out_rel[b0:b0 + nb] = np.asarray(r.rel_change)[:nb]
        out_ovf[b0:b0 + nb] = np.asarray(r.overflow)[:nb]

    # transfers run in worker threads: device_put / host fetches can hold
    # the calling thread for the whole transfer, which would serialise
    # them with compute DISPATCH; two
    # workers keep the H2D of chunk k+1 and the D2H of chunk k-1 off the
    # main thread while chunk k computes (at most 3 chunks are ever live)
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=2) as pool:
        fetches = []
        nxt = pool.submit(put_chunk, 0)
        prev = None
        for i in range(n_chunks):
            nb, cspec, Sc = nxt.result()
            r = solve(cspec, Sc, omega, tol=tol, max_iters=max_iters,
                      check_every=check_every, scheme=scheme,
                      tol_type=tol_type)
            # enqueue the D2H copies behind the solve; non-blocking
            for leaf in (r.S, r.iters, r.rel_change, r.overflow):
                leaf.copy_to_host_async()
            if i + 1 < n_chunks:
                nxt = pool.submit(put_chunk, i + 1)
            if prev is not None:
                fetches.append(pool.submit(fetch, *prev))
            prev = (i, nb, r)
        fetches.append(pool.submit(fetch, *prev))
        for f in fetches:
            f.result()                    # propagate worker exceptions

    return SolveResult(
        S=out_S.reshape(batch_shape + grid),
        iters=out_it.reshape(batch_shape),
        rel_change=out_rel.reshape(batch_shape),
        overflow=out_ovf.reshape(batch_shape))
