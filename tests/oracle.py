# -*- coding: utf-8 -*-
"""Tiny, slow numpy oracles implementing the reference SOR semantics
(lexicographic in-place Gauss-Seidel, /root/reference/xinvert/numbas.py) from
the published update formulas.  Used only to validate that the red-black
engine converges to the same fixed point (and, for the red-black oracle,
runs the same iterates) on small grids."""
import numpy as np


def sor_standard_2d(S, A, B, C, F, dely, delx, bcy, bcx, omega, undef,
                    n_iters=2000, tol=0.0):
    """Lexicographic SOR for d/dy(A Sy + B Sx) + d/dx(B Sy + C Sx) = F."""
    S = S.copy()
    yc, xc = S.shape
    ratio = delx / dely
    rsq = ratio ** 2
    rq = ratio / 4.0
    dxsq = delx ** 2
    norm_prev = np.finfo(np.float64).max

    def defined(v):
        return v != undef

    for loop in range(n_iters):
        if bcy == "extend":
            if bcx == "periodic":
                for i in range(xc):
                    if defined(S[1, i]):
                        S[0, i] = S[1, i]
                    if defined(S[-2, i]):
                        S[-1, i] = S[-2, i]
            else:
                for i in range(1, xc - 1):
                    if defined(S[1, i]):
                        S[0, i] = S[1, i]
                    if defined(S[-2, i]):
                        S[-1, i] = S[-2, i]
                if defined(S[1, 1]):
                    S[0, 0] = S[1, 1]
                if defined(S[1, -2]):
                    S[0, -1] = S[1, -2]
                if defined(S[-2, 1]):
                    S[-1, 0] = S[-2, 1]
                if defined(S[-2, -2]):
                    S[-1, -1] = S[-2, -2]

        cols = range(xc) if bcx == "periodic" else range(1, xc - 1)
        for j in range(1, yc - 1):
            for i in cols:
                ip = (i + 1) % xc
                im = (i - 1) % xc
                ok = (defined(F[j, i]) and defined(A[j + 1, i]) and
                      defined(A[j, i]) and defined(B[j, ip]) and
                      defined(B[j, im]) and defined(B[j + 1, i]) and
                      defined(B[j - 1, i]) and defined(C[j, ip]) and
                      defined(C[j, i]))
                if not ok:
                    continue
                temp = ((A[j + 1, i] * (S[j + 1, i] - S[j, i])
                         - A[j, i] * (S[j, i] - S[j - 1, i])) * rsq
                        + (B[j + 1, i] * (S[j + 1, ip] - S[j + 1, im])
                           - B[j - 1, i] * (S[j - 1, ip] - S[j - 1, im])) * rq
                        + (B[j, ip] * (S[j + 1, ip] - S[j - 1, ip])
                           - B[j, im] * (S[j + 1, im] - S[j - 1, im])) * rq
                        + (C[j, ip] * (S[j, ip] - S[j, i])
                           - C[j, i] * (S[j, i] - S[j, im]))
                        - F[j, i] * dxsq)
                denom = (A[j + 1, i] + A[j, i]) * rsq + (C[j, ip] + C[j, i])
                S[j, i] += omega * temp / denom
        norm = np.mean(np.abs(S))
        if tol > 0 and abs(norm - norm_prev) / norm_prev < tol:
            break
        norm_prev = norm
    return S


def lexicographic_from_spec(spec, S, omega, n_iters, extend_fn=None):
    """Generic in-place lexicographic SOR over a compiled StencilSpec:
    visits active cells in row-major order, applying the folded update with
    wrap-around neighbor indexing (jnp.roll semantics).  Reproduces the
    reference's ordering given the (independently validated) folding."""
    import numpy as np

    S = np.array(S, dtype=float)
    w = np.asarray(spec.w)
    w0 = np.asarray(spec.w0)
    g = np.asarray(spec.g)
    relax = np.asarray(spec.relax)
    active = np.asarray(spec.active)
    offsets = spec.offsets
    shape = S.shape

    for _ in range(n_iters):
        if extend_fn is not None:
            S = np.array(extend_fn(S))
        for idx in np.ndindex(*shape):
            if not active[idx]:
                continue
            acc = g[idx]
            for k, off in enumerate(offsets):
                nidx = tuple((i + o) % n for i, o, n in
                             zip(idx, off, shape))
                acc += w[(k,) + idx] * S[nidx]
            S[idx] += omega * relax[idx] * (acc + w0[idx] * S[idx])
    return S


def _extend_numpy(S, bcs, bih):
    """The extend pre-pass on one slice, written out row by row: the first
    and last rows (two each for the biharmonic ring) copy the nearest
    interior row, columns clamped into the interior unless x is periodic;
    3-D volumes extend their interior z levels only; 1-D extends the
    line's two ends."""
    S = S.copy()
    if S.ndim == 1:
        if bcs[-1] == "extend":
            S[0], S[-1] = S[1], S[-2]
        return S
    if bcs[-2] != "extend":
        return S
    if S.ndim == 3:
        for z in range(1, S.shape[0] - 1):
            S[z] = _extend_numpy(S[z], bcs[1:], False)
        return S
    ny, nx = S.shape
    periodic = bcs[-1] == "periodic"
    ring = 2 if bih else 1
    cols = np.arange(nx) if periodic else np.clip(np.arange(nx), ring,
                                                  nx - 1 - ring)
    if not bih:
        S[0] = S[1, cols]
        S[-1] = S[-2, cols]
    elif periodic:
        r1, r2, r3 = S[1].copy(), S[2].copy(), S[-3].copy()
        S[0], S[1], S[-2], S[-1] = r1, r2, r3, r3
    else:
        top, bot = S[2, cols].copy(), S[-3, cols].copy()
        S[0], S[1], S[-2], S[-1] = top, top, bot, bot
    return S


def redblack_from_spec(spec, S, omega, n_iters):
    """Red-black SOR over a compiled StencilSpec, in numpy: per iteration
    the extend pre-pass, then the cells with an even sum of core indices,
    then the odd ones; each half-sweep updates the active cells of its
    colour from the state before it, ``S += omega * relax * (sum_k w_k
    S[. + off_k] + w0 S + g)``, neighbours indexed with wrap-around.
    Leading batch dims of ``S`` (and of the spec planes, where batched)
    run slice by slice."""
    S = np.array(S, dtype=np.asarray(spec.w0).dtype)
    nd = spec.ndim
    core = S.shape[-nd:]
    batch = S.shape[:-nd]
    planes = {k: np.asarray(getattr(spec, k))
              for k in ("w0", "g", "relax", "active")}
    w = np.asarray(spec.w)
    idx = np.indices(core)
    colour = idx.sum(axis=0) % 2

    def sl(a, b, lead=0):
        if a.ndim - lead > nd:
            return a[(slice(None),) * lead + b]
        return a

    out = np.empty_like(S)
    for b in np.ndindex(*batch):
        Sb = S[b].copy()
        w0, g, relax, active = (sl(planes[k], b) for k in
                                ("w0", "g", "relax", "active"))
        wb = sl(w, b, lead=1)
        nbr = [tuple((idx[a] + off[a]) % core[a] for a in range(nd))
               for off in spec.offsets]
        for _ in range(n_iters):
            Sb = _extend_numpy(Sb, spec.bcs, spec.bih)
            for c in (0, 1):
                acc = g.copy()
                for k, ni in enumerate(nbr):
                    acc = acc + wb[k] * Sb[ni]
                upd = active & (colour == c)
                new = Sb + omega * relax * (acc + w0 * Sb)
                Sb = np.where(upd, new, Sb)
        out[b] = Sb
    return out
