# -*- coding: utf-8 -*-
"""Explicit halo-exchange SOR executor: ``shard_map`` over a ('y','x') mesh
with ``lax.ppermute`` ring shifts of the block edges.

The GSPMD path (mesh.py) lets the partitioner derive the halo traffic from
sharding annotations.  This module is the hand-scheduled equivalent — the
collective pattern the BASELINE targets name explicitly — tuned for
latency-bound multi-host meshes: ONE exchange per half-sweep, carrying only
the values the next color's update can read.

- Red-black structure: the black half-sweep reads only values produced by
  (or unchanged since) the red half, so each half-sweep needs exactly one
  fresh ring.  The extend-BC pre-pass is applied locally by the edge
  devices (their own interior rows supply the extended values; no other
  device reads rows that shallow — guarded by ``by >= ring + radius``).
- Color packing: for nearest-neighbor stencils (no diagonal couplings) a
  half-sweep of one color reads ONLY opposite-color halo values, so the
  exchanged rings are stride-2 packed — half the bytes.  Diagonal/biharmonic
  stencils exchange full rings (both colors are read).

Net exchanged bytes per iteration drop from 3-4 full rings (pad + extend
re-pad + per-color re-pads) to 1 full-ring equivalent for the
nearest-neighbor families (2 half-packed exchanges), verified by the
trace-time traffic counter ``last_traffic_bytes_per_iter``.

Correctness requires the red/black parity and the extend-BC pre-pass to be
computed in GLOBAL coordinates; both are derived from the device's block
offset (`lax.axis_index` x local block shape) inside the mapped function.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..stencil import StencilSpec

__all__ = ["solve_fixed_halo", "last_traffic_bytes_per_iter"]

# trace-time accounting: bytes moved by ppermute per ITERATION of the last
# traced solve (the fori_loop body is traced once, so summing payload sizes
# during tracing yields exactly the per-iteration traffic).  NOTE: a
# module-global mutated at trace time — a TEST/diagnostic counter only, not
# load-bearing; concurrent or re-entrant traces would interleave updates,
# so never branch library behavior on it.
_traffic = {"bytes": 0}


def last_traffic_bytes_per_iter() -> int:
    return _traffic["bytes"]


def _ppermute(data, axis_name, perm):
    _traffic["bytes"] += int(np.prod(data.shape) * data.dtype.itemsize)
    return jax.lax.ppermute(data, axis_name, perm)


def _ring_halo(local, axis_name, width, axis, n):
    """Gather `width` rows/cols from both mesh neighbors along `axis`.

    Returns (lo_halo, hi_halo): the neighbor data adjacent to this block's
    low/high edge (wrap-around ring; callers mask or ignore invalid use).
    `n` is the static mesh extent along `axis_name`.
    """
    def take(sl):
        return jax.lax.slice_in_dim(local, *sl, axis=axis)

    size = local.shape[axis]
    hi_edge = (size - width, size)    # my top rows -> neighbor above me
    lo_edge = (0, width)

    if n == 1:
        # single device on this axis: ring neighbor is myself (periodic wrap)
        return take(hi_edge), take(lo_edge)

    fwd = [(i, (i + 1) % n) for i in range(n)]     # send toward +axis
    bwd = [(i, (i - 1) % n) for i in range(n)]
    lo_halo = _ppermute(take(hi_edge), axis_name, fwd)
    hi_halo = _ppermute(take(lo_edge), axis_name, bwd)
    return lo_halo, hi_halo


def _pack2(a, axis, s0):
    """Take every other element along `axis` starting at traced offset s0."""
    n = a.shape[axis]
    shp = list(a.shape)
    shp[axis:axis + 1] = [n // 2, 2]
    pairs = a.reshape(shp)
    return jax.lax.dynamic_index_in_dim(pairs, s0, axis=axis + 1,
                                        keepdims=False)


def _unpack2(vals, axis, s0, n):
    """Inverse of _pack2: interleave zeros at the complementary parity."""
    sel = jax.lax.broadcasted_iota(jnp.int32, (2,), 0)
    expand = list(vals.shape)
    expand.insert(axis + 1, 2)
    pick = (sel == s0).reshape((1,) * (axis + 1) + (2,)
                               + (1,) * (vals.ndim - axis - 1))
    out = jnp.where(pick, jnp.expand_dims(vals, axis + 1), 0.0)
    shp = list(vals.shape)
    shp[axis] = n
    return out.reshape(shp)


def solve_fixed_halo(spec: StencilSpec, S, omega, n_iters: int,
                     mesh: Optional[Mesh] = None, k_sweeps: int = 1):
    """Fixed-iteration sharded solve with explicit ppermute halo exchange.

    Equivalent to ``solve_fixed`` for 2-D specs; batch dims are supported
    and stay unsharded (shard over 'batch' with the GSPMD path if needed).

    ``k_sweeps > 1`` selects the COMMUNICATION-AVOIDING variant (the
    multi-device analog of the fused sweep kernel, ops/sor2d.py): halos of width
    ``2 * radius * k_sweeps`` are exchanged once per k iterations and each
    device runs k padded local iterations, so the message COUNT per
    iteration drops 2k-fold (2 exchanges per k iterations vs 2 per
    half-sweep) at the cost of wider rings and
    ``(b + 2h)^2 / b^2`` redundant compute.  The right trade for
    latency-bound links between hosts; per-half-sweep packed exchange
    (k=1) moves fewer bytes on bandwidth-bound links.  Bit-identical to ``solve_fixed``
    for any k: owned cells only ever read ghost values inside the fresh
    dependence cone (tests/test_parallel.py).
    """
    if spec.ndim == 3:
        # 3-D volumes (the reference's omega / 3DOcean families,
        # numbas.py:16-212, :746-984): z stays device-local (the reference
        # never updates z boundaries, so local z rolls match the global
        # sweep exactly), y/x shard with ghost rings via the
        # communication-avoiding executor — parity and the interior-z
        # extend pre-pass generalise by one z term
        return _solve_fixed_halo_kavoid(spec, S, omega, n_iters, mesh,
                                        max(int(k_sweeps), 1))
    if spec.ndim != 2:
        raise ValueError("halo executor supports 2-D and 3-D problems")
    if k_sweeps > 1:
        return _solve_fixed_halo_kavoid(spec, S, omega, n_iters, mesh,
                                        int(k_sweeps))
    for name in ("w0", "g", "relax"):
        a = getattr(spec, name)
        if a.ndim > jnp.ndim(S):
            raise ValueError(
                f"spec.{name} has batch dims beyond S (shape {a.shape} vs "
                f"{jnp.shape(S)}); pass a matching batched S or an "
                "unbatched spec")
    if mesh is None:
        from .mesh import make_grid_mesh
        mesh = make_grid_mesh()
    ring = 2 if spec.bih else 1
    radius = max(max(abs(o) for o in off) for off in spec.offsets)
    ny, nx = S.shape[-2:]
    my_, mx_ = mesh.shape["y"], mesh.shape["x"]
    if ny % my_ or nx % mx_:
        raise ValueError(f"grid {ny}x{nx} not divisible by mesh {my_}x{mx_}")
    by, bx = ny // my_, nx // mx_
    if by < ring + radius or bx < ring + radius:
        raise ValueError("block smaller than halo ring + stencil radius")

    # nearest-neighbor stencils read only the opposite color: pack halos
    no_cross = (ring == 1 and
                all(sum(1 for o in off if o != 0) == 1
                    for off in spec.offsets))
    pack = no_cross and by % 2 == 0 and bx % 2 == 0

    omega = jnp.asarray(omega, S.dtype)
    from ..solver import _color_relax
    rr, rb = _color_relax(spec, omega)

    grid_spec = P(*((None,) * (S.ndim - 2) + ("y", "x")))

    def plane_spec(a):
        return P(*((None,) * (a.ndim - 2) + ("y", "x")))

    extend_y = spec.bcs[-2] == "extend"
    periodic_x = spec.bcs[-1] == "periodic"
    offsets = spec.offsets
    nd = S.ndim

    _traffic["bytes"] = 0

    def local_step(w, w0, g, rrl, rbl, Sl):
        iy = jax.lax.axis_index("y")
        ix = jax.lax.axis_index("x")
        y0 = iy * by
        x0 = ix * bx

        # global red/black parity of the local block
        row = jax.lax.broadcasted_iota(jnp.int32, (by, bx), 0) + y0
        col = jax.lax.broadcasted_iota(jnp.int32, (by, bx), 1) + x0
        red = ((row + col) % 2 == 0).astype(Sl.dtype)
        rr_loc = rrl * red
        rb_loc = rbl * (1.0 - red)

        first_y = iy == 0
        last_y = iy == my_ - 1

        def apply_extend(Sl):
            """Extend-BC pre-pass, LOCAL to the edge devices: boundary rows
            copy adjacent interior rows of the same block (``by >= ring +
            radius`` guarantees no other device reads rows that shallow).
            Mirrors solver._apply_extend in global coordinates."""
            grow = jax.lax.broadcasted_iota(jnp.int32, (by, bx), 0) + y0
            gcol = jax.lax.broadcasted_iota(jnp.int32, (by, bx), 1) + x0
            up1 = jnp.roll(Sl, -1, nd - 2)
            dn1 = jnp.roll(Sl, 1, nd - 2)

            def colfix(a, width):
                if periodic_x:
                    return a
                out = a
                for w_ in range(1, width + 1):
                    out = jnp.where(gcol == w_ - 1,
                                    jnp.roll(a, -(width - w_ + 1), nd - 1),
                                    out)
                    out = jnp.where(gcol == nx - w_,
                                    jnp.roll(a, width - w_ + 1, nd - 1), out)
                return out

            # x-rolls stay inside the block except at block seams, where
            # the copied rows' x-neighbors live on another device.  The
            # corner-clamp columns (gcol < ring or >= nx - ring) are always
            # inside the first/last x blocks together with their sources
            # (bx >= ring + radius), so colfix is block-local too.
            if not spec.bih:
                top = colfix(up1, 1)
                bot = colfix(dn1, 1)
                Sl = jnp.where(jnp.logical_and(first_y, grow == 0), top, Sl)
                Sl = jnp.where(jnp.logical_and(last_y, grow == ny - 1), bot,
                               Sl)
                return Sl

            up2 = jnp.roll(Sl, -2, nd - 2)
            dn2 = jnp.roll(Sl, 2, nd - 2)
            if periodic_x:
                top = up1
            else:
                top = jnp.where(grow == 0, up2, up1)
                top = colfix(top, 2)
            bot = jnp.where(grow == ny - 1, dn2, dn1)
            if not periodic_x:
                bot = colfix(bot, 2)
            Sl = jnp.where(jnp.logical_and(first_y, grow <= 1), top, Sl)
            Sl = jnp.where(jnp.logical_and(last_y, grow >= ny - 2), bot, Sl)
            return Sl

        def exchange(Sl, parity):
            """Fresh halos carrying (when packable) only `parity` values.

            Returns the padded block; corners are zero for packed
            nearest-neighbor exchanges (never read) and filled through the
            sequential y-then-x padding otherwise."""
            if not pack:
                lo_y, hi_y = _ring_halo(Sl, "y", ring, nd - 2, my_)
                Sp = jnp.concatenate([lo_y, Sl, hi_y], axis=nd - 2)
                lo_x, hi_x = _ring_halo(Sp, "x", ring, nd - 1, mx_)
                return jnp.concatenate([lo_x, Sp, hi_x], axis=nd - 1)

            # --- packed path (ring == 1) ---
            # y-halos: single rows at global rows y0-1 / y0+by; the needed
            # elements satisfy (grow + gcol) % 2 == parity
            def pack_row(rowvals, grow_of_row):
                s0 = (parity - grow_of_row - x0) % 2
                return _pack2(rowvals, nd - 1, s0), s0

            top_row = jax.lax.slice_in_dim(Sl, by - 1, by, axis=nd - 2)
            bot_row = jax.lax.slice_in_dim(Sl, 0, 1, axis=nd - 2)
            # my top row has grow y0+by-1; as the receiver's lo halo it
            # keeps its global row, so pack by its own parity start
            top_p, _ = pack_row(top_row, y0 + by - 1)
            bot_p, _ = pack_row(bot_row, y0)
            if my_ == 1:
                lo_p, hi_p = top_p, bot_p
            else:
                fwd = [(i, (i + 1) % my_) for i in range(my_)]
                bwd = [(i, (i - 1) % my_) for i in range(my_)]
                lo_p = _ppermute(top_p, "y", fwd)
                hi_p = _ppermute(bot_p, "y", bwd)
            # unpack with the halo rows' own global parities
            s0_lo = (parity - (y0 - 1) - x0) % 2
            s0_hi = (parity - (y0 + by) - x0) % 2
            lo_y = _unpack2(lo_p, nd - 1, s0_lo, bx)
            hi_y = _unpack2(hi_p, nd - 1, s0_hi, bx)

            # x-halos: single columns at gcol x0-1 / x0+bx, packed along y
            def pack_col(colvals, gcol_of_col):
                s0 = (parity - gcol_of_col - y0) % 2
                return _pack2(colvals, nd - 2, s0)

            right_col = jax.lax.slice_in_dim(Sl, bx - 1, bx, axis=nd - 1)
            left_col = jax.lax.slice_in_dim(Sl, 0, 1, axis=nd - 1)
            right_p = pack_col(right_col, x0 + bx - 1)
            left_p = pack_col(left_col, x0)
            if mx_ == 1:
                lo_xp, hi_xp = right_p, left_p
            else:
                fwd = [(i, (i + 1) % mx_) for i in range(mx_)]
                bwd = [(i, (i - 1) % mx_) for i in range(mx_)]
                lo_xp = _ppermute(right_p, "x", fwd)
                hi_xp = _ppermute(left_p, "x", bwd)
            s0_lo_x = (parity - (x0 - 1) - y0) % 2
            s0_hi_x = (parity - (x0 + bx) - y0) % 2
            lo_x = _unpack2(lo_xp, nd - 2, s0_lo_x, by)
            hi_x = _unpack2(hi_xp, nd - 2, s0_hi_x, by)

            # assemble padded block with zero corners (never read)
            Sp = jnp.concatenate([lo_y, Sl, hi_y], axis=nd - 2)
            zc = jnp.zeros(Sp.shape[:nd - 2] + (1, 1), Sp.dtype)
            lo_x = jnp.concatenate([zc, lo_x, zc], axis=nd - 2)
            hi_x = jnp.concatenate([zc, hi_x, zc], axis=nd - 2)
            return jnp.concatenate([lo_x, Sp, hi_x], axis=nd - 1)

        def half_sweep(Sl, rel, parity):
            """Update `parity` cells: one exchange carrying the values the
            update reads (the opposite color, when packable)."""
            Sp = exchange(Sl, 1 - parity if pack else parity)
            acc = g
            for k, off in enumerate(offsets):
                dy, dx = off
                acc = acc + w[k] * jax.lax.dynamic_slice_in_dim(
                    jax.lax.dynamic_slice_in_dim(
                        Sp, ring + dy, by, nd - 2),
                    ring + dx, bx, nd - 1)
            return Sl + rel * (acc + w0 * Sl)

        def one_iter(_, Sl):
            if extend_y:
                Sl = apply_extend(Sl)
            Sl = half_sweep(Sl, rr_loc, 0)     # red reads black halos
            Sl = half_sweep(Sl, rb_loc, 1)     # black reads fresh red halos
            return Sl

        return jax.lax.fori_loop(0, n_iters, one_iter, Sl)

    mapped = shard_map(
        local_step, mesh=mesh,
        in_specs=(plane_spec(spec.w), plane_spec(spec.w0), plane_spec(spec.g),
                  plane_spec(rr), plane_spec(rb), grid_spec),
        out_specs=grid_spec,
    )
    out = mapped(spec.w, spec.w0, spec.g, rr, rb, jnp.asarray(S))
    # the fori_loop body traces once: recorded bytes are per iteration
    return out


def _solve_fixed_halo_kavoid(spec: StencilSpec, S, omega,
                             n_iters: int, mesh: Optional[Mesh],
                             k_sweeps: int):
    """Ghost-zone (communication-avoiding) sharded executor: one exchange
    per ``k_sweeps`` iterations with halos covering the k-sweep dependence
    cone.  See ``solve_fixed_halo``; the validity-frontier argument is the
    same as the fused sweep kernel's (ops/sor2d.py): a
    ghost cell at depth j holds globally-correct values through iteration
    i while j <= h - 2*radius*i, and owned cells only ever read inside
    that frontier.  Beyond-domain ghosts on non-periodic edges hold
    wrapped garbage but are only read by boundary cells, which never
    update (relax = 0; extend rows are overwritten from interior rows)."""
    if mesh is None:
        from .mesh import make_grid_mesh
        mesh = make_grid_mesh()
    # ghost width covers the y/x dependence cone only: z (3-D) is
    # device-local, so z coupling costs no exchange
    radius = max(max(abs(o) for o in off[-2:]) for off in spec.offsets)
    h = 2 * radius * k_sweeps
    ny, nx = S.shape[-2:]
    nz = S.shape[-3] if spec.ndim == 3 else None
    my_, mx_ = mesh.shape["y"], mesh.shape["x"]
    if ny % my_ or nx % mx_:
        raise ValueError(f"grid {ny}x{nx} not divisible by mesh {my_}x{mx_}")
    by, bx = ny // my_, nx // mx_
    if (by <= h and my_ > 1) or (bx <= h and mx_ > 1):
        raise ValueError(f"halo width {h} (k_sweeps={k_sweeps}) needs "
                         f"blocks larger than the halo; got {by}x{bx}")

    omega = jnp.asarray(omega, S.dtype)
    from ..solver import _color_relax
    rr, rb = _color_relax(spec, omega)

    grid_spec = P(*((None,) * (S.ndim - 2) + ("y", "x")))

    def plane_spec(a):
        return P(*((None,) * (a.ndim - 2) + ("y", "x")))

    extend_y = spec.bcs[-2] == "extend"
    periodic_x = spec.bcs[-1] == "periodic"
    offsets = spec.offsets
    bih = spec.bih
    nd = S.ndim

    _traffic["bytes"] = 0

    def pad_hw(a, width, ya, xa):
        """Pad both core axes with `width` neighbor rings (y then x on the
        padded array, so corners carry genuine neighbor-of-neighbor data)."""
        lo_y, hi_y = _ring_halo(a, "y", width, ya, my_)
        ap = jnp.concatenate([lo_y, a, hi_y], axis=ya)
        lo_x, hi_x = _ring_halo(ap, "x", width, xa, mx_)
        return jnp.concatenate([lo_x, ap, hi_x], axis=xa)

    def local_step(w, w0, g, rrl, rbl, Sl):
        iy = jax.lax.axis_index("y")
        ix = jax.lax.axis_index("x")
        y0 = iy * by - h                      # global row of padded row 0
        x0 = ix * bx - h
        py, px = by + 2 * h, bx + 2 * h

        # weights/relax padded ONCE per solve (loop-invariant; counted
        # separately from the per-iteration S traffic)
        wp = pad_hw(w, h, nd - 2 + (w.ndim - nd), nd - 1 + (w.ndim - nd))
        w0p = pad_hw(w0, h, w0.ndim - 2, w0.ndim - 1)
        gp = pad_hw(g, h, g.ndim - 2, g.ndim - 1)
        rrp = pad_hw(rrl, h, rrl.ndim - 2, rrl.ndim - 1)
        rbp = pad_hw(rbl, h, rbl.ndim - 2, rbl.ndim - 1)
        setup_bytes = _traffic["bytes"]
        _traffic["bytes"] = 0

        row_g = jax.lax.broadcasted_iota(jnp.int32, (py, px), 0) + y0
        col_g = jax.lax.broadcasted_iota(jnp.int32, (py, px), 1) + x0
        # 3-D: the reference extends y rows for INTERIOR z levels only
        # (numbas.py:87-115) and never updates z boundaries
        zsel = (jnp.ones((), bool) if nz is None else
                (lambda zi: (zi >= 1) & (zi <= nz - 2))(
                    jax.lax.broadcasted_iota(jnp.int32, (nz, 1, 1), 0)))

        def apply_extend(Sp):
            """Extend pre-pass in global coordinates on the padded block —
            fires wherever boundary rows appear (owned or ghost), keeping
            ghost-row updates identical to the global sweep."""
            up1 = jnp.roll(Sp, -1, nd - 2)
            dn1 = jnp.roll(Sp, 1, nd - 2)

            def colfix(a, width):
                if periodic_x:
                    return a
                out = a
                for w_ in range(1, width + 1):
                    out = jnp.where(col_g == w_ - 1,
                                    jnp.roll(a, -(width - w_ + 1), nd - 1),
                                    out)
                    out = jnp.where(col_g == nx - w_,
                                    jnp.roll(a, width - w_ + 1, nd - 1), out)
                return out

            if not bih:
                Sp = jnp.where((row_g == 0) & zsel, colfix(up1, 1), Sp)
                Sp = jnp.where((row_g == ny - 1) & zsel, colfix(dn1, 1), Sp)
                return Sp
            up2 = jnp.roll(Sp, -2, nd - 2)
            dn2 = jnp.roll(Sp, 2, nd - 2)
            if periodic_x:
                top = up1
            else:
                top = colfix(jnp.where(row_g == 0, up2, up1), 2)
            bot = jnp.where(row_g == ny - 1, dn2, dn1)
            if not periodic_x:
                bot = colfix(bot, 2)
            Sp = jnp.where(row_g <= 1, top, Sp)
            Sp = jnp.where(row_g >= ny - 2, bot, Sp)
            return Sp

        par = row_g + col_g
        if nz is not None:
            par = par + jax.lax.broadcasted_iota(jnp.int32, (nz, 1, 1), 0)
        red = (par % 2 == 0).astype(Sl.dtype)
        rr_loc = rrp * red
        rb_loc = rbp * (1.0 - red)

        def padded_iter(Sp):
            if extend_y:
                Sp = apply_extend(Sp)
            for rel in (rr_loc, rb_loc):
                acc = gp
                for k, off in enumerate(offsets):
                    *dzs, dy, dx = off
                    nb = jnp.roll(
                        jnp.roll(Sp, -dy, nd - 2), -dx, nd - 1)
                    if dzs and dzs[0]:
                        # z is device-local; the wrap feeds only inactive
                        # z-boundary cells, exactly like the global sweep
                        nb = jnp.roll(nb, -dzs[0], nd - 3)
                    acc = acc + wp[k] * nb
                Sp = Sp + rel * (acc + w0p * Sp)
            return Sp

        n_chunks = -(-n_iters // k_sweeps)
        rem = n_iters - (n_chunks - 1) * k_sweeps

        def chunk(c, Sl):
            Sp = pad_hw(Sl, h, nd - 2, nd - 1)
            k_eff = jnp.where(c == n_chunks - 1, rem, k_sweeps)
            Sp = jax.lax.fori_loop(
                0, k_eff, lambda i, s: padded_iter(s), Sp)
            return jax.lax.slice_in_dim(
                jax.lax.slice_in_dim(Sp, h, h + by, axis=nd - 2),
                h, h + bx, axis=nd - 1)

        out = jax.lax.fori_loop(0, n_chunks, chunk, Sl)
        # per-iteration accounting: the chunk body traced once moved one
        # exchange; amortise over k_sweeps and add back the one-time setup
        _traffic["bytes"] = _traffic["bytes"] // k_sweeps
        _traffic.setdefault("setup", 0)
        _traffic["setup"] = setup_bytes
        return out

    mapped = shard_map(
        local_step, mesh=mesh,
        in_specs=(plane_spec(spec.w), plane_spec(spec.w0), plane_spec(spec.g),
                  plane_spec(rr), plane_spec(rb), grid_spec),
        out_specs=grid_spec,
    )
    return mapped(spec.w, spec.w0, spec.g, rr, rb, jnp.asarray(S))
