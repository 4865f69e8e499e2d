# -*- coding: utf-8 -*-
"""Fused multi-sweep red-black SOR for 2-D stencils: window plan, the
CUDA launch, and the plan's jnp executor.

The XLA sweep (solver._sweep_with) rereads the state and all K+3
coefficient planes once per colour, so a sweep costs about 2(K+5) plane
passes through device memory.  The CUDA kernel (csrc/sor2d.cu) instead
runs ``k`` sweeps per launch on ghost-zone windows held in shared memory:

- block (by, bx) owns rows ``[by*tile_y, (by+1)*tile_y)`` and columns
  ``[bx*tile_x, (bx+1)*tile_x)`` of one batch slice (clipped to the grid);
- it reads a ``win_y x win_x`` window around its tile: ``halo = 2*radius*k``
  ghost cells on each side, since one red-black iteration moves
  information at most ``2*radius`` cells.  Rows are clamped into the
  domain (the window slides inward at the top and bottom); columns wrap
  when x is periodic and are clamped otherwise;
- cells within ``radius`` of a window edge are never updated.  At a
  domain edge those are the boundary ring, which the sweep leaves alone
  (``_interior_mask``: the first/last ``ring >= radius`` rows, and columns
  unless x is periodic); at an interior edge they lie outside the owned
  tile's dependence cone;
- the extend pre-pass runs in the windows that hold the domain's first or
  last rows, reading its sources (always inward of the window edge) from
  the window;
- only the owned tile is written back.

So the owned tile after a launch equals ``k`` XLA sweeps.  This module
keeps the plan (:func:`window_plan`, :func:`window_geometry`) in Python,
where the CPU tests reach it, together with :func:`launch_jnp`, a pure-jnp
executor of one launch of the same plan: the kernel's arithmetic
reference, used by tests only.  The kernel itself runs only on an NVIDIA
GPU (``solver.choose_sweep`` decides when).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ["WindowPlan", "window_plan", "window_geometry", "launch_jnp",
           "prepare_planes", "sor_sweeps", "Sweeper"]

# limits of the compiled kernel (csrc/sor2d.cu)
THREADS = 512
MAX_WINDOW_POINTS = THREADS * 16
MAX_HALF_POINTS = THREADS * 8
MAX_OFFSETS = 24
SMEM_BYTES = 226 * 1024     # of the 227 KB a block may opt in to
# window width in x.  On an H100 (700 W), 2048^2 masked Poisson, 500
# sweeps: 96 columns (75-row windows, k=4) ran 26.0 ms, 64/80/112/128/160
# columns 28-30 ms; on the 37 x 721 x 1440 batch 87 ms against 89-103 ms
WIN_X = 96


class WindowPlan(NamedTuple):
    tile_y: int
    tile_x: int
    halo: int          # ghost cells per side: 2 * radius * k
    win_y: int
    win_x: int
    k: int             # sweeps per launch (the halo covers k)


def radius(offsets) -> int:
    return max(max(abs(o) for o in off) for off in offsets)


def window_plan(spec, shape, win_x: int = WIN_X,
                win_points: Optional[int] = None,
                max_k: Optional[int] = None):
    """The launch geometry for ``spec`` on a ``(..., ny, nx)`` state, or
    None when the kernel does not apply.

    Applies to 2-D specs whose offsets stay inside the boundary ring
    (radius 1, or 2 for the biharmonic family), at most ``MAX_OFFSETS``
    of them, grids of at least 8 x 8 cells, and an even ``nx`` when x is
    periodic (the red-black colouring must stay a checkerboard across the
    seam).  ``k`` is 4 sweeps per launch for radius 1 and 2 for radius 2
    (at most ``max_k``: a solve checking every sweep launches one sweep at
    a time, and a narrower ghost zone serves it better); it is lowered
    until the tile holds at least 8 rows.  The window fills the shared
    memory a block may use: the state plus the K+3 coefficient planes, 4
    bytes a cell each (``win_x`` and ``win_points`` shrink it; tests use
    them to get many blocks on small grids).
    """
    if len(spec.bcs) != 2:
        return None
    ny, nx = (int(n) for n in shape[-2:])
    K = len(spec.offsets)
    r = radius(spec.offsets)
    ring = 2 if spec.bih else 1
    periodic_x = spec.bcs[-1] == "periodic"
    if (K > MAX_OFFSETS or r > ring or ny < 8 or nx < 8
            or (periodic_x and nx % 2)):
        return None
    cap = min(MAX_WINDOW_POINTS, SMEM_BYTES // (4 * (K + 4)))
    if win_points is not None:
        cap = min(cap, int(win_points))
    k0 = 4 if r == 1 else 2
    if max_k:
        k0 = max(1, min(k0, int(max_k)))
    for kk in range(k0, 0, -1):
        h = 2 * r * kk
        if periodic_x:
            tx = min(nx, win_x - 2 * h)
            wx = tx + 2 * h
        elif nx <= win_x:
            tx = wx = nx
        else:
            wx = win_x
            tx = wx - 2 * h
        if tx < 8:
            continue
        wy = min(cap // wx, 2 * MAX_HALF_POINTS // (wx + 1))
        if ny <= wy:
            ty = wy = ny
        else:
            ty = wy - 2 * h
        if ty < 8:
            continue
        return WindowPlan(ty, tx, h, wy, wx, kk)
    return None


class Geometry(NamedTuple):
    y0: np.ndarray        # (n_by,) first window row
    x0: np.ndarray        # (n_bx,) first window column, unwrapped
    rows: np.ndarray      # (n_by, win_y) global rows
    cols: np.ndarray      # (n_bx, win_x) global columns (wrapped)
    extend_src: np.ndarray  # (n_by, n_bx, win_y*win_x) local source or -1
    owner: tuple          # 4 x (ny, nx): (by, bx, ly, lx) of each cell's owner


def window_geometry(plan: WindowPlan, ny: int, nx: int, bcs, bih: bool):
    """Which rows and columns each block reads, where each cell's owner
    keeps it, and which window cells the extend pre-pass overwrites (with
    the local index it copies from)."""
    ty, tx, h, wy, wx = plan.tile_y, plan.tile_x, plan.halo, plan.win_y, \
        plan.win_x
    periodic_x = bcs[-1] == "periodic"
    n_by, n_bx = -(-ny // ty), -(-nx // tx)
    y0 = np.clip(np.arange(n_by) * ty - h, 0, ny - wy)
    x0 = np.arange(n_bx) * tx - h
    if not periodic_x:
        x0 = np.clip(x0, 0, nx - wx)
    rows = y0[:, None] + np.arange(wy)
    cols_u = x0[:, None] + np.arange(wx)
    cols = cols_u % nx if periodic_x else cols_u

    src = np.full((n_by, n_bx, wy, wx), -1, np.int64)
    if bcs[-2] == "extend":
        gy = rows[:, None, :, None]
        gx = cols_u[None, :, None, :]
        if not bih:
            sy = np.where(gy == 0, 1, np.where(gy == ny - 1, ny - 2, -1))
        else:
            sy = np.where(gy == 0, 1 if periodic_x else 2,
                          np.where(gy == 1, 2,
                                   np.where(gy >= ny - 2, ny - 3, -1)))
        sy = np.broadcast_to(sy, src.shape)
        if periodic_x:
            dxs = np.zeros_like(gx)
        else:
            lo = 2 if bih else 1
            dxs = np.clip(gx, lo, nx - 1 - lo) - gx
        ly = np.arange(wy)[None, None, :, None]
        lx = np.arange(wx)[None, None, None, :]
        sly = ly + (sy - gy)
        slx = lx + dxs
        ok = (sy >= 0) & (sly >= 0) & (sly < wy) & (slx >= 0) & (slx < wx)
        src = np.where(ok, sly * wx + slx, -1)
    gy = np.arange(ny)
    gx = np.arange(nx)
    by = gy // ty
    bx = gx // tx
    ly = gy - y0[by]
    lx = gx - x0[bx]
    owner = tuple(np.broadcast_to(a, (ny, nx)) for a in
                  (by[:, None], bx[None, :], ly[:, None], lx[None, :]))
    return Geometry(y0, x0, rows, cols, src.reshape(n_by, n_bx, wy * wx),
                    owner)


def prepare_planes(spec, S_shape, omega, dtype=jnp.float32):
    """The kernel's operands: ``w`` as (K, b, ny, nx) and w0, g and
    ``omega * relax`` as (b, ny, nx), with b the flattened batch size, or
    1 where the plane is shared by all slices."""
    ny, nx = S_shape[-2:]
    batch = tuple(S_shape[:-2])
    B = int(np.prod(batch, dtype=np.int64))

    def planes(a, lead=()):
        a = jnp.asarray(a, dtype)
        if a.ndim == len(lead) + 2:
            return a.reshape(lead + (1, ny, nx))
        a = jnp.broadcast_to(a, lead + batch + (ny, nx))
        return a.reshape(lead + (B, ny, nx))

    K = len(spec.offsets)
    rel = jnp.asarray(omega, dtype) * spec.relax
    return (planes(spec.w, (K,)), planes(spec.w0), planes(spec.g),
            planes(rel))


def launch_jnp(plan: WindowPlan, spec, S, w, w0, g, rel, sweeps: int):
    """One kernel launch of ``sweeps`` iterations, in jnp, on the kernel's
    operands (S as (B, ny, nx); see :func:`prepare_planes`).  The same
    windows, the same extend copies and the same arithmetic order as the
    CUDA kernel."""
    B, ny, nx = S.shape
    geo = window_geometry(plan, ny, nx, spec.bcs, spec.bih)
    wy, wx = plan.win_y, plan.win_x
    r = radius(spec.offsets)
    ri = jnp.asarray(geo.rows)[:, None, :, None]
    ci = jnp.asarray(geo.cols)[None, :, None, :]

    def gather(a):                 # (..., ny, nx) -> (..., n_by, n_bx, wy, wx)
        return a[..., ri, ci]

    Sw = gather(S)
    Ww, W0w, Gw, Rw = gather(w), gather(w0), gather(g), gather(rel)
    colour = ((geo.rows[:, None, :, None] + geo.cols[None, :, None, :]) % 2)
    core = (Ellipsis, slice(r, wy - r), slice(r, wx - r))
    src = jnp.asarray(geo.extend_src)
    has_src = src >= 0
    extend = spec.bcs[-2] == "extend"

    for _ in range(sweeps):
        if extend:
            flat = Sw.reshape(Sw.shape[:-2] + (wy * wx,))
            idx = jnp.broadcast_to(jnp.maximum(src, 0), flat.shape)
            taken = jnp.take_along_axis(flat, idx, axis=-1)
            Sw = jnp.where(has_src, taken, flat).reshape(Sw.shape)
        for c in (0, 1):
            acc = Gw[core]
            for k, (dy, dx) in enumerate(spec.offsets):
                acc = acc + Ww[k][core] * Sw[..., r + dy:wy - r + dy,
                                             r + dx:wx - r + dx]
            sel = jnp.asarray((colour == c)[core], S.dtype)
            Sc = Sw[core]
            Sw = Sw.at[core].set(Sc + (Rw[core] * sel) * (acc + W0w[core] * Sc))
    by, bx, ly, lx = (jnp.asarray(a) for a in geo.owner)
    return Sw[:, by, bx, ly, lx]


_TARGET = "xinvert_sor2d"


def launch_cuda(plan: WindowPlan, spec, S, w, w0, g, rel, sweeps: int):
    """One launch of the CUDA kernel (builds and registers it on first
    use; a failed build raises)."""
    from .cuda_build import load_sor2d
    load_sor2d()
    i32 = np.int32
    return jax.ffi.ffi_call(
        _TARGET, jax.ShapeDtypeStruct(S.shape, S.dtype),
        vmap_method="sequential")(
            S, w, w0, g, rel,
            offsets=np.asarray(spec.offsets, i32).reshape(-1),
            sweeps=i32(sweeps), tile_y=i32(plan.tile_y),
            tile_x=i32(plan.tile_x), halo=i32(plan.halo),
            win_y=i32(plan.win_y), win_x=i32(plan.win_x),
            periodic_x=i32(spec.bcs[-1] == "periodic"),
            extend_y=i32(spec.bcs[-2] == "extend"), bih=i32(spec.bih))


# the launcher the sweeper calls; tests swap in launch_jnp to run the
# kernel path's control flow on the CPU
_launch = launch_cuda


class Sweeper:
    """Runs SOR sweeps on one (spec, omega) through the kernel, a launch
    per ``plan.k`` sweeps.  The operands are prepared once, outside any
    solve loop."""

    def __init__(self, spec, S_shape, omega, max_k: Optional[int] = None):
        self.spec = spec
        self.shape = tuple(S_shape)
        self.plan = window_plan(spec, S_shape, max_k=max_k)
        if self.plan is None:
            raise ValueError(f"no kernel window plan for {spec.offsets} "
                             f"on {S_shape}")
        self.planes = prepare_planes(spec, S_shape, omega, spec.w0.dtype)

    def _one(self, S3, n):
        return _launch(self.plan, self.spec, S3, *self.planes, n)

    def __call__(self, S, n: int):
        """Exactly ``n`` (static) sweeps."""
        k = self.plan.k
        S3 = S.reshape((-1,) + self.shape[-2:])
        full, rem = divmod(int(n), k)
        if full == 1:
            S3 = self._one(S3, k)
        elif full:
            S3 = jax.lax.fori_loop(0, full, lambda i, s: self._one(s, k), S3)
        if rem:
            S3 = self._one(S3, rem)
        return S3.reshape(S.shape)

    def dynamic(self, S, n):
        """``n`` (traced) sweeps: launches of ``k``, then single sweeps."""
        k = self.plan.k
        S3 = S.reshape((-1,) + self.shape[-2:])
        S3 = jax.lax.fori_loop(0, n // k, lambda i, s: self._one(s, k), S3)
        S3 = jax.lax.fori_loop(0, n % k, lambda i, s: self._one(s, 1), S3)
        return S3.reshape(S.shape)


def sor_sweeps(spec, S, omega, n_iters: int):
    """``n_iters`` SOR iterations through the kernel."""
    return Sweeper(spec, jnp.shape(S), omega)(S, n_iters)
