# -*- coding: utf-8 -*-
"""Red-black SOR engine and convergence driver.

Data-parallel replacement for the reference's lexicographic in-place Gauss-Seidel
sweeps (/root/reference/xinvert/numbas.py).  A lexicographic sweep is a serial
dependency chain over the whole grid and cannot use a vector core; the
red-black (checkerboard) ordering splits each sweep into two fully parallel
half-sweeps with identical fixed point and comparable convergence rate at the
same over-relaxation factor.  Diagonal (cross-derivative) and +-2 biharmonic
couplings connect same-color points; those read the previous half-sweep's
values, which keeps the scheme convergent for the damped elliptic problems the
framework targets (validated against the reference oracles in tests/).

Everything here is ``jax.jit``-compatible and batch-aware: arrays may carry
arbitrary leading batch dimensions (the reference's `loop_noncore` sequential
batch loop, core.py:129-139, becomes one vectorised solve), and the whole
driver is a single ``lax.while_loop`` so XLA keeps the iteration on-device.
Convergence control replicates the reference exactly: the masked mean-|S| norm
(numbas.py:absNorm2D:1711-1728), the relative-change stopping rule, overflow
detection and the (overflow, rel-change, loop-count) flags telemetry
(numbas.py:401-414).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .stencil import StencilSpec

__all__ = ["SolveResult", "solve", "solve_fixed", "solve_fixed_cheby",
           "solve_trajectory", "sweep", "rho2_from_omega"]


@partial(jax.tree_util.register_dataclass,
         data_fields=["S", "iters", "rel_change", "overflow"], meta_fields=[])
@dataclasses.dataclass
class SolveResult:
    """Solution plus the reference's ``flags`` telemetry (apps.py:2308-2311)."""
    S: jnp.ndarray
    iters: jnp.ndarray       # loop count at termination (per batch element)
    rel_change: jnp.ndarray  # last relative change of the norm
    overflow: jnp.ndarray    # bool, divergence detected


# ---------------------------------------------------------------------------
# boundary pre-pass ('extend' rows), applied once per iteration before the
# sweep, exactly like the reference kernels (numbas.py:284-310, :1299-1343).
# Only the second-to-last dim honours 'extend' (and the last dim in 1D); the
# reference ignores extend on other dims and we replicate that.
# ---------------------------------------------------------------------------

def _clamp_cols(row, ring):
    """``row[..., clip(i, ring, nx - 1 - ring)]``: the extend copy's corner
    clamp, as whole-row rolls and selects.  Partial-width updates of a row
    (``.at[..., 1:-1]``) are avoided on purpose: XLA's SPMD partitioner
    misplaces them when x is sharded."""
    col = jax.lax.broadcasted_iota(jnp.int32, row.shape, row.ndim - 1)
    nx = row.shape[-1]
    out = row
    for d in range(1, ring + 1):
        out = jnp.where(col == ring - d, jnp.roll(row, -d, axis=-1), out)
        out = jnp.where(col == nx - 1 - ring + d, jnp.roll(row, d, axis=-1),
                        out)
    return out


def _apply_extend(spec: StencilSpec, S):
    nd = spec.ndim
    if nd == 1:
        if spec.bcs[-1] == "extend":
            S = S.at[..., 0].set(S[..., 1])
            S = S.at[..., -1].set(S[..., -2])
        return S
    if spec.bcs[-2] != "extend":
        return S
    periodic_x = spec.bcs[-1] == "periodic"
    if nd == 2 and not spec.bih:
        top, bot = S[..., 1, :], S[..., -2, :]
        if not periodic_x:
            top, bot = _clamp_cols(top, 1), _clamp_cols(bot, 1)
        S = S.at[..., 0, :].set(top).at[..., -1, :].set(bot)
    elif nd == 2 and spec.bih:
        if periodic_x:
            # sequential reference semantics: S[0]=old S[1]; S[1]=S[2]
            r1, r2 = S[..., 1, :], S[..., 2, :]
            S = S.at[..., 0, :].set(r1).at[..., 1, :].set(r2)
            bm3 = S[..., -3, :]
            S = S.at[..., -1, :].set(bm3).at[..., -2, :].set(bm3)
        else:
            # rows 0, 1 <- row 2 and rows -2, -1 <- row -3, columns
            # clamped into [2, nx-3] (the reference's 2x2 corner blocks)
            top = _clamp_cols(S[..., 2, :], 2)
            bot = _clamp_cols(S[..., -3, :], 2)
            S = S.at[..., 0, :].set(top).at[..., 1, :].set(top)
            S = S.at[..., -1, :].set(bot).at[..., -2, :].set(bot)
    else:  # 3D: rows extended for interior z levels only (numbas.py:87-115)
        top, bot = S[..., 1:-1, 1, :], S[..., 1:-1, -2, :]
        if not periodic_x:
            top, bot = _clamp_cols(top, 1), _clamp_cols(bot, 1)
        S = S.at[..., 1:-1, 0, :].set(top).at[..., 1:-1, -1, :].set(bot)
    return S


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def _checkerboard(shape, dtype):
    """(sum of core indices) % 2 == 0 mask."""
    total = 0
    nd = len(shape)
    for ax, n in enumerate(shape):
        idx = jax.lax.broadcasted_iota(jnp.int32, shape, ax)
        total = total + idx
    return (total % 2 == 0).astype(dtype)


def _neighbor_sum(spec: StencilSpec, S):
    """sum_k w_k * S[. + off_k] + g  over the core (trailing) axes."""
    nd = spec.ndim
    acc = spec.g
    for k, off in enumerate(spec.offsets):
        shifts = tuple(-o for o in off if o != 0)
        axes = tuple(ax - nd for ax, o in enumerate(off) if o != 0)
        acc = acc + spec.w[k] * jnp.roll(S, shift=shifts, axis=axes)
    return acc


def _color_relax(spec: StencilSpec, omega):
    """The two per-color relaxation planes: omega * active/(-w0) * color."""
    core_shape = spec.w0.shape[-spec.ndim:]
    red = _checkerboard(core_shape, spec.w0.dtype)
    r = omega * spec.relax
    return r * red, r * (1.0 - red)


def sweep(spec: StencilSpec, S, omega):
    """One full SOR iteration: extend pre-pass + red half + black half."""
    rr, rb = _color_relax(spec, omega)
    return _sweep_with(spec, S, rr, rb)


def _sweep_with(spec: StencilSpec, S, rr, rb):
    S = _apply_extend(spec, S)
    for r in (rr, rb):
        acc = _neighbor_sum(spec, S)
        S = S + r * (acc + spec.w0 * S)
    return S


def rho2_from_omega(omega):
    """Jacobi spectral-radius estimate rho^2 from an SOR factor.

    Inverts omega_opt = 2 / (1 + sqrt(1 - rho^2)) — the same relation the
    reference's grid-optimal formula is built on (apps.py:2289-2290) — so
    the grid-derived omega doubles as the Chebyshev parameter source.
    """
    s = 2.0 / omega - 1.0
    return jnp.clip(1.0 - s * s, 0.0, 1.0 - 1e-12)


def _cheby_next(m, w, rho2):
    """The cyclic Chebyshev semi-iterative factor for half-sweep ``m``
    (0-based), given the previous factor ``w`` (Golub & Varga 1961):
    w(0)=1, w(1)=1/(1-rho2/2), w(m+1)=1/(1-rho2*w(m)/4)."""
    return jnp.where(m == 0, 1.0,
                     jnp.where(m == 1, 1.0 / (1.0 - rho2 / 2.0),
                               1.0 / (1.0 - rho2 * w / 4.0)))


def _sweep_cheby(spec: StencilSpec, S, m, w, rho2, base_r, base_b):
    """One full iteration of cyclic-Chebyshev red-black SOR: each
    half-sweep uses the next factor of the semi-iterative recurrence
    (ramping 1 -> omega_opt).  Same fixed point and same asymptotic rate
    as constant omega_opt SOR; measured parity-class iterate counts on the
    gallery problems (the ramp removes the theoretical m*rho^m transient
    factor, worth having when rho is known better than the omega
    heuristic, but it is not a speedup over a well-tuned omega — use
    multigrid for that)."""
    S = _apply_extend(spec, S)
    for base in (base_r, base_b):
        w = _cheby_next(m, w, rho2).astype(S.dtype)
        m = m + 1
        acc = _neighbor_sum(spec, S)
        S = S + (w * base) * (acc + spec.w0 * S)
    return S, m, w


def _norm(spec: StencilSpec, S):
    """Masked mean |S| over the core dims (absNorm*, numbas.py:1690-1747).

    The reference counts cells whose value differs from the undef sentinel;
    the solution array never holds the sentinel (initS is 0 or icbc,
    apps.py:2141-2156), so this is the plain mean of |S| per slice.
    """
    axes = tuple(range(-spec.ndim, 0))
    return jnp.mean(jnp.abs(S), axis=axes)


def _residual_norm(spec: StencilSpec, S):
    """Mean |sum_k w_k S[.+off_k] + w0 S + g| over active cells, per slice —
    the TRUE discrete residual of the folded system (what multigrid already
    monitors), as opposed to the reference's solution-change rule."""
    axes = tuple(range(-spec.ndim, 0))
    r = jnp.where(spec.active, _neighbor_sum(spec, S) + spec.w0 * S, 0.0)
    n_active = jnp.maximum(jnp.sum(spec.active), 1)
    return jnp.sum(jnp.abs(r), axis=axes) / n_active


def _residual_scale(spec: StencilSpec):
    """Normaliser for the relative residual: per-slice mean |g| over active
    cells (the forcing magnitude), with a dtype floor for zero forcing."""
    axes = tuple(range(-spec.ndim, 0))
    g = jnp.where(spec.active, spec.g, 0.0)
    n_active = jnp.maximum(jnp.sum(spec.active), 1)
    s = jnp.sum(jnp.abs(g), axis=axes) / n_active
    return jnp.maximum(s, jnp.finfo(spec.g.dtype).tiny)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

class SweepChoice(NamedTuple):
    """How a solve runs its sweeps: ``kernel`` is ``"xla"`` (the roll
    sweep, every platform) or ``"cuda"`` (ops/sor2d.py, NVIDIA GPUs), and
    ``check_every`` is the default convergence-check cadence."""
    kernel: str
    check_every: int


def _platform() -> str:
    return jax.default_backend()


def _multi_device(*arrays) -> bool:
    """True when a concrete operand is sharded over several devices (the
    FFI kernel has no partitioning rule; GSPMD keeps the XLA sweep)."""
    for a in arrays:
        if isinstance(a, jax.core.Tracer):
            continue
        sh = getattr(a, "sharding", None)
        if sh is not None and len(sh.device_set) > 1:
            return True
    return False


def choose_sweep(spec, S, scheme: str = "sor",
                 max_iters: Optional[int] = None) -> SweepChoice:
    """The one place that decides how sweeps run, from the platform, the
    dtype, the shape and the sharding.

    - ``kernel``: the fused CUDA kernel for float32 2-D red-black SOR on a
      GPU, on one device, when its window plan applies
      (``ops.sor2d.window_plan``); the XLA roll sweep otherwise.
    - ``check_every``: on a GPU at float32 the convergence test runs every
      ``min(32, max_iters // 10)`` sweeps, so the norm and the loop trip
      are paid once per window.  The solution-change rule then compares
      norms a whole window apart, so a tolerance is met later than with
      per-sweep checks (see PERF.md).  ``scheme="lexico"`` (reference
      parity of the per-sweep stopping rule), float64 and the CPU check
      every sweep.
    """
    gpu = _platform() == "gpu"
    f32 = jnp.dtype(S.dtype) == jnp.float32
    check_every = 1
    if gpu and f32 and scheme != "lexico" and max_iters is not None:
        check_every = max(1, min(32, int(max_iters) // 10))
    kernel = "xla"
    if (gpu and f32 and scheme == "sor" and spec.ndim == 2
            and not _multi_device(S, spec.w0)):
        from .ops.sor2d import window_plan
        if window_plan(spec, jnp.shape(S)) is not None:
            kernel = "cuda"
    return SweepChoice(kernel, check_every)


def _solve_impl(spec, S0, omega, tol, max_iters, check_every=1,
                kernel="xla", scheme="sor", tol_type="change"):
    dtype = S0.dtype
    batch_shape = jnp.shape(S0)[: S0.ndim - spec.ndim]
    r_scale = _residual_scale(spec) if tol_type == "residual" else None

    sweeps_aux, init_aux = None, ()
    if scheme == "cheby":
        # Chebyshev semi-iteration: per-half-sweep factors, with the
        # (m, w) recurrence state in the loop carry
        base_r, base_b = _color_relax(spec, jnp.asarray(1.0, dtype))
        rho2 = rho2_from_omega(jnp.asarray(omega, dtype))

        def sweeps_aux(S, aux, k):
            def it(_, c):
                S, m, w = c
                return _sweep_cheby(spec, S, m, w, rho2, base_r, base_b)
            return jax.lax.fori_loop(0, k, it, (S, aux[0], aux[1]))

        init_aux = (jnp.zeros((), jnp.int32), jnp.ones((), dtype))
    elif scheme == "lexico":
        # the reference's exact iterate sequence (lexico.py): checked
        # solves then reproduce the notebooks' published per-slice
        # (loops, tolerance) records to the printed digits
        # (tests/test_notebook_parity.py)
        from .lexico import lexico_sweeper
        one = lexico_sweeper(spec, jnp.asarray(omega, dtype), jnp.shape(S0))

        def sweeps(S, k, full):
            return jax.lax.fori_loop(0, k, lambda i, s: one(s), S)
    elif kernel == "cuda":
        # operands prepared once, outside the while loop; a check window
        # of check_every sweeps is ceil(check_every / plan.k) launches
        from .ops.sor2d import Sweeper
        sweeper = Sweeper(spec, jnp.shape(S0), omega, max_k=check_every)

        def sweeps(S, k, full):
            return sweeper(S, check_every) if full else sweeper.dynamic(S, k)
    elif check_every == 1:
        rr, rb = _color_relax(spec, jnp.asarray(omega, dtype))

        def sweeps(S, k, full):
            return _sweep_with(spec, S, rr, rb)
    else:
        rr, rb = _color_relax(spec, jnp.asarray(omega, dtype))

        def sweeps(S, k, full):
            return jax.lax.fori_loop(
                0, k, lambda i, s: _sweep_with(spec, s, rr, rb), S)

    # norm_prev < 0 marks "no previous norm yet".  (The reference uses a
    # float-max sentinel, numbas.py; |norm - MAX| / MAX can lower to a
    # multiply by the subnormal 1/MAX, which flush-to-zero hardware turns
    # into rel == 0 -> instant false convergence.)
    init = dict(
        S=S0,
        it=jnp.zeros((), jnp.int32),      # total sweeps run (scalar)
        loop=jnp.zeros(batch_shape, jnp.int32),
        norm_prev=jnp.full(batch_shape, -1.0, dtype),
        rel=jnp.ones(batch_shape, dtype),
        overflow=jnp.zeros(batch_shape, bool),
        done=jnp.zeros(batch_shape, bool),
        aux=init_aux,                     # cheby (m, w) recurrence state
    )

    def cond(c):
        # the hot loop runs only FULL check windows; the clamped mxLoop
        # remainder is a one-off tail step outside the loop, so the body
        # stays free of data-dependent branches
        return jnp.any(~c["done"]) & (c["it"] + check_every
                                      <= max_iters.astype(jnp.int32))

    def advance(c, k_eff, full):
        # one check window: k_eff sweeps, then the convergence/telemetry
        # update.  `full` is STATIC: True in the while body (k_eff ==
        # check_every, a static sweep count), False in the tail (dynamic
        # remainder count)
        if sweeps_aux is not None:
            S_new, m_new, w_new = sweeps_aux(c["S"], c["aux"], k_eff)
            aux_new = (m_new, w_new)
        else:
            S_new = sweeps(c["S"], k_eff, full)
            aux_new = c["aux"]
        if tol_type == "residual":
            # extension: stop on the TRUE relative discrete residual
            # mean|r|/mean|g| (what multigrid monitors) instead of the
            # reference's solution-change rule
            norm = jnp.broadcast_to(_residual_norm(spec, S_new), batch_shape)
            rel = norm / r_scale
        else:
            norm = _norm(spec, S_new)
            prev = c["norm_prev"]
            rel = jnp.where(prev >= 0,
                            jnp.abs(norm - prev)
                            / jnp.where(prev > 0, prev, 1.0),
                            jnp.ones_like(norm))
        # reference: isnan(norm) or norm > 1e100 (numbas.py:403); ~isfinite
        # additionally catches inf, which for float32 subsumes the 1e100 test.
        overflow = ~jnp.isfinite(norm)
        if dtype == jnp.float64:
            overflow = overflow | (norm > 1e100)
        # reference loop semantics (numbas.py:401-414): sweep, increment,
        # then test — so exactly mxLoop sweeps run at the cap and `iters`
        # counts sweeps performed
        new_loop = c["loop"] + k_eff
        stop = overflow | (rel < tol) | (new_loop >= max_iters)
        if spec.stop_on_zero_norm and tol_type != "residual":
            stop = stop | (norm == 0)
        if np.prod(batch_shape, dtype=np.int64) == 1:
            # single batch element: the loop exits the moment `done` flips
            # (cond is any(~done)), so the body never runs on a finished
            # element — the freeze `where`s are identity and the one on S
            # would cost a full extra state read+write per check
            def frz(done, old, new):
                return new

            def frz_state(old, new):
                return new
        else:
            def frz(done, old, new):
                return jnp.where(done, old, new)

            def frz_state(old, new):
                d = c["done"].reshape(batch_shape + (1,) * spec.ndim)
                return jnp.where(d, old, new)
        return dict(
            S=frz_state(c["S"], S_new),
            it=c["it"] + k_eff,
            loop=frz(c["done"], c["loop"], new_loop),
            norm_prev=frz(c["done"], c["norm_prev"], norm),
            rel=frz(c["done"], c["rel"], rel),
            overflow=frz(c["done"], c["overflow"], overflow),
            done=c["done"] | stop,
            aux=aux_new,
        )

    out = jax.lax.while_loop(
        cond, lambda c: advance(c, jnp.int32(check_every), True), init)
    # clamped remainder so exactly mxLoop sweeps run even when check_every
    # does not divide it (reference semantics: sweep, increment, test)
    rem = max_iters.astype(jnp.int32) - out["it"]
    out = jax.lax.cond(
        jnp.any(~out["done"]) & (rem > 0),
        lambda c: advance(c, rem, False),
        lambda c: c, out)
    return SolveResult(S=out["S"], iters=out["loop"], rel_change=out["rel"],
                       overflow=out["overflow"])


_solve_jit = partial(jax.jit,
                     static_argnames=("check_every", "kernel", "scheme", "tol_type"))(
    _solve_impl)


def _kernel_for(spec, S0, use_kernel, scheme="sor"):
    """``use_kernel``: None -> :func:`choose_sweep`; False -> the XLA
    sweep; True -> the CUDA kernel (an error where it cannot run)."""
    if use_kernel is None:
        return choose_sweep(spec, S0, scheme).kernel
    if not use_kernel:
        return "xla"
    from .ops.sor2d import window_plan
    if scheme != "sor" or window_plan(spec, jnp.shape(S0)) is None:
        raise ValueError("use_kernel=True: the CUDA sweep kernel does not "
                         f"apply to this problem ({spec.bcs}, "
                         f"{jnp.shape(S0)}, scheme={scheme!r})")
    return "cuda"


def solve(spec: StencilSpec, S0, omega: Optional[float] = None,
          tol: float = 1e-8, max_iters: int = 5000,
          check_every: int = 1,
          use_kernel: Optional[bool] = None,
          scheme: str = "sor",
          tol_type: str = "change") -> SolveResult:
    """Iterate to convergence with the reference's stopping rule.

    Parameters mirror iParams: ``tol`` is the relative change of the mean-|S|
    norm between iterations (a solution-change criterion, not a residual),
    ``max_iters`` the reference's mxLoop.  ``omega`` defaults to the
    grid-optimal factor if None (pass one explicitly for parity runs).

    ``check_every`` amortises the convergence reduction over k sweeps (the
    termination test then sees the norm every k-th iterate; k=1 reproduces
    the reference exactly).  ``use_kernel`` (None: :func:`choose_sweep`
    decides; on a GPU, 2-D float32 SOR runs the fused CUDA kernel of
    ops/sor2d.py) forces the kernel (True) or the XLA sweep (False).

    ``scheme="lexico"`` runs the reference's EXACT lexicographic iterate
    sequence (lexico.py) under this stopping rule — published xinvert
    runs reproduce to the printed digits on f64 workloads
    (tests/test_notebook_parity.py, E2E.json); keep ``check_every=1``
    for stopping parity.

    ``tol_type="residual"`` (an extension) stops on the TRUE
    relative discrete residual mean|r|/mean|g| over active cells instead of
    the reference's solution-change rule — the change rule can fire
    spuriously early when the iterate momentarily stalls; the residual rule
    certifies the equation is actually satisfied.  ``rel_change`` in the
    result then reports the final relative residual.  Note the achievable
    floor is set by rounding: roughly eps * mean|w0*S| / mean|g| (e.g.
    ~1e-8 in f64 for the global streamfunction problems, where |S| is ~1e12
    times machine epsilon) — tolerances below the floor run to mxLoop.
    """
    if omega is None:
        from .grid import optimal_omega
        omega = optimal_omega(S0.shape[-spec.ndim:])
    S0 = jnp.asarray(S0)
    if scheme not in ("sor", "cheby", "direct", "lexico"):
        raise ValueError(f"unknown scheme {scheme!r}; "
                         "use 'sor', 'cheby', 'direct' or 'lexico'")
    if scheme == "direct":
        # one-shot spectral solve (ops/direct.py): exact, no iteration.
        # iters reports 1 "sweep"; rel_change certifies the true relative
        # discrete residual of the returned solution.
        from .ops.direct import solve_direct
        S = solve_direct(spec, S0)
        batch_shape = jnp.shape(S)[: S.ndim - spec.ndim]
        rel = jnp.broadcast_to(
            _residual_norm(spec, S) / _residual_scale(spec), batch_shape)
        return SolveResult(
            S=S, iters=jnp.ones(batch_shape, jnp.int32),
            rel_change=rel.astype(S.dtype),
            overflow=~jnp.isfinite(_norm(spec, S))
            & jnp.ones(batch_shape, bool))
    if tol_type not in ("change", "residual"):
        raise ValueError(f"unknown tol_type {tol_type!r}; "
                         "use 'change' or 'residual'")
    if scheme in ("sor", "cheby"):
        # drop identically-zero weight planes (Munk-class biharmonic
        # specs carry 8 of 16 zero): a sweep's memory traffic scales with
        # the plane count (stencil.prune_zero_offsets; exact)
        from .stencil import prune_zero_offsets
        spec = prune_zero_offsets(spec)
    kernel = _kernel_for(spec, S0, use_kernel, scheme)
    return _solve_jit(spec, S0, jnp.asarray(omega, S0.dtype),
                      jnp.asarray(tol, S0.dtype),
                      jnp.asarray(max_iters, jnp.int32),
                      check_every=int(check_every), kernel=kernel,
                      scheme=scheme, tol_type=tol_type)


@partial(jax.jit, static_argnames=("n_iters",))
def _solve_fixed_xla(spec: StencilSpec, S0, omega, n_iters: int):
    rr, rb = _color_relax(spec, jnp.asarray(omega, S0.dtype))
    return jax.lax.fori_loop(
        0, n_iters, lambda i, S: _sweep_with(spec, S, rr, rb), S0)


@partial(jax.jit, static_argnames=("n_iters",))
def _solve_fixed_cuda(spec: StencilSpec, S0, omega, n_iters: int):
    from .ops.sor2d import Sweeper
    return Sweeper(spec, jnp.shape(S0), omega)(S0, n_iters)


def solve_fixed(spec: StencilSpec, S0, omega, n_iters: int,
                use_kernel: Optional[bool] = None):
    """Run exactly n_iters SOR iterations (no convergence checks).

    The hot path for benchmarking and for fixed-iteration parity tests.
    ``use_kernel`` as in :func:`solve`: by default :func:`choose_sweep`
    picks the fused CUDA kernel (ops/sor2d.py) or the XLA roll sweep.

    NOTE: unlike :func:`solve`, this does NOT call
    ``stencil.prune_zero_offsets`` — the prune check is a device->host
    sync, and callers here typically chain many calls on one spec.  Prune
    once yourself for zero-plane-heavy specs (the Munk biharmonic class).
    """
    S0 = jnp.asarray(S0)
    if _kernel_for(spec, S0, use_kernel) == "cuda":
        return _solve_fixed_cuda(spec, S0, omega, n_iters)
    return _solve_fixed_xla(spec, S0, omega, n_iters)


@partial(jax.jit, static_argnames=("n_iters",))
def solve_fixed_cheby(spec: StencilSpec, S0, omega, n_iters: int):
    """Run exactly ``n_iters`` cyclic-Chebyshev red-black SOR iterations
    (SURVEY 7.8's optional accelerator).  The half-sweep factor follows
    the Golub-Varga semi-iterative recurrence seeded by the Jacobi
    spectral radius implied by ``omega`` (``rho2_from_omega``).  Same
    fixed point and asymptotic rate as constant-omega_opt SOR; measured
    parity-class error decay on the gallery problems (see _sweep_cheby)."""
    S0 = jnp.asarray(S0)
    dtype = S0.dtype
    base_r, base_b = _color_relax(spec, jnp.asarray(1.0, dtype))
    rho2 = rho2_from_omega(jnp.asarray(omega, dtype))

    def it(_, c):
        S, m, w = c
        return _sweep_cheby(spec, S, m, w, rho2, base_r, base_b)

    S, _, _ = jax.lax.fori_loop(
        0, n_iters, it, (S0, jnp.zeros((), jnp.int32),
                         jnp.ones((), dtype)))
    return S


@partial(jax.jit, static_argnames=("loop_per_frame", "max_frames", "scheme"))
def solve_trajectory(spec: StencilSpec, S0, omega,
                     loop_per_frame: int = 5, max_frames: int = 30,
                     scheme: str = "sor"):
    """Solution snapshots every `loop_per_frame` iterations.

    The on-device `animate_iteration` (apps.py:895-1058): one lax.scan whose
    carry is the warm-restarted solution, emitting a snapshot per frame.
    Returns an array stacked along a leading `frame` axis.

    ``scheme='lexico'`` snapshots the reference's EXACT iterate sequence
    (lexico.py) — the frames the reference's own ``animate_iteration``
    would draw, rather than the red-black transient.  ``scheme='cheby'``
    snapshots the cyclic-Chebyshev trajectory (the (m, w) factor
    recurrence rides the scan carry).  One-shot schemes ('direct') have
    no trajectory and are rejected.
    """
    S0 = jnp.asarray(S0)
    dtype = S0.dtype
    if scheme not in ("sor", "lexico", "cheby"):
        raise ValueError(
            f"solve_trajectory supports scheme 'sor', 'lexico' or "
            f"'cheby', got {scheme!r} (a one-shot 'direct' solve has no "
            "trajectory)")
    if scheme == "cheby":
        base_r, base_b = _color_relax(spec, jnp.asarray(1.0, dtype))
        rho2 = rho2_from_omega(jnp.asarray(omega, dtype))

        def frame(c, _):
            def it(_, c):
                S, m, w = c
                return _sweep_cheby(spec, S, m, w, rho2, base_r, base_b)
            c = jax.lax.fori_loop(0, loop_per_frame, it, c)
            return c, c[0]

        _, frames = jax.lax.scan(
            frame, (S0, jnp.zeros((), jnp.int32), jnp.ones((), dtype)),
            None, length=max_frames)
        return frames
    if scheme == "lexico":
        from .lexico import lexico_sweeper
        one = lexico_sweeper(spec, jnp.asarray(omega, dtype),
                             jnp.shape(S0))
    else:
        rr, rb = _color_relax(spec, jnp.asarray(omega, dtype))

        def one(S):
            return _sweep_with(spec, S, rr, rb)

    def frame(S, _):
        S = jax.lax.fori_loop(0, loop_per_frame, lambda i, s: one(s), S)
        return S, S

    _, frames = jax.lax.scan(frame, S0, None, length=max_frames)
    return frames
