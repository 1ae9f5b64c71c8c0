"""ODE integration: fixed-grid and adaptive explicit RK, fully jittable.

Rebuild of the solver layer the reference gets from DifferentialEquations.jl
(Tsit5 + InterpolatingAdjoint/ZygoteVJP, reference
docs/src/tutorials/graph_node.md:53-66). Here the whole solve — control flow
included — is one XLA program (``lax.scan`` over save intervals with a
``lax.while_loop`` adaptive stepper inside), so the aggregation runs inside
every solver stage without host round-trips.

Adjoints:
- ``odeint_grid``      — fixed-step ``lax.scan``; reverse-mode differentiates
  through the scan with per-step rematerialization (``jax.checkpoint``), the
  checkpointed-adjoint replacement for the reference's InterpolatingAdjoint.
- ``odeint``           — adaptive with embedded error control; reverse mode via
  the continuous backsolve adjoint (custom_vjp integrating the augmented
  system backwards), the classic neural-ODE adjoint.

Conventions: ``rhs(t, y, args)``; ``y``/``args`` arbitrary pytrees; ``ts`` is
an increasing 1-D array of save times; returns ys stacked on a leading time
axis (``ys[0] == y0``).
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax import lax

from .tableaus import Tableau, get_tableau

map_tree = jax.tree_util.tree_map


def _tree_lincomb(coeffs, trees):
    """sum_i coeffs[i] * trees[i] over matching pytrees."""
    return map_tree(lambda *leaves: sum(c * l for c, l in zip(coeffs, leaves)),
                    *trees)


def _tree_add_scaled(y, h, k):
    return map_tree(lambda a, b: a + h * b, y, k)


def _tree_where(pred, a, b):
    return map_tree(lambda x, y: jnp.where(pred, x, y), a, b)


def _rk_step(rhs, tab: Tableau, t, y, h, f0, args):
    """One explicit RK step. Returns (y1, err, f_last).

    ``f0`` is f(t, y) (reused as stage 0 — FSAL-friendly). ``f_last`` is the
    final stage evaluation; for FSAL tableaus it equals f(t+h, y1).
    """
    ks = [f0]
    for i in range(1, tab.stages):
        ti = t + tab.c[i] * h
        incr = _tree_lincomb(tab.a[i], ks[: len(tab.a[i])])
        yi = _tree_add_scaled(y, h, incr)
        ks.append(rhs(ti, yi, args))
    y1 = _tree_add_scaled(y, h, _tree_lincomb(tab.b, ks))
    err = None
    if tab.adaptive:
        err = map_tree(lambda *leaves: h * sum(
            c * l for c, l in zip(tab.b_err, leaves)), *ks)
    f_last = ks[-1]
    return y1, err, f_last


# ---------------------------------------------------------------- fixed grid
def odeint_grid(
    rhs: Callable,
    y0: Any,
    ts: jax.Array,
    args: Any = None,
    *,
    solver="rk4",
    steps_per_interval: int = 1,
    checkpoint: bool = True,
) -> Any:
    """Fixed-step solve hitting every ``ts`` point exactly.

    Each save interval is subdivided into ``steps_per_interval`` equal steps.
    Differentiable in reverse mode; with ``checkpoint=True`` each step is
    rematerialized in the backward pass (recursive-checkpoint adjoint).
    """
    tab = get_tableau(solver)

    def step(carry, t_dt):
        y = carry
        t, dt = t_dt
        f0 = rhs(t, y, args)
        y1, _, _ = _rk_step(rhs, tab, t, y, dt, f0, args)
        return y1, None

    if checkpoint:
        step = jax.checkpoint(step)

    def interval(y, t01):
        t0, t1 = t01
        n = steps_per_interval
        dt = (t1 - t0) / n
        sub_ts = t0 + dt * jnp.arange(n)
        y1, _ = lax.scan(step, y, (sub_ts, jnp.full((n,), dt)))
        return y1, y1

    _, ys_tail = lax.scan(interval, y0, (ts[:-1], ts[1:]))
    return map_tree(
        lambda first, rest: jnp.concatenate([first[None], rest], axis=0),
        y0, ys_tail)


# ------------------------------------------------------------------ adaptive
def _error_ratio(err, y0, y1, rtol, atol):
    sq_sum = 0.0
    count = 0
    for e, a, b in zip(jax.tree_util.tree_leaves(err),
                       jax.tree_util.tree_leaves(y0),
                       jax.tree_util.tree_leaves(y1)):
        scale = atol + rtol * jnp.maximum(jnp.abs(a), jnp.abs(b))
        r = e / scale
        sq_sum = sq_sum + jnp.sum(r * r)
        count += r.size
    return jnp.sqrt(sq_sum / count)


def _optimal_dt(dt, ratio, order, safety=0.9, min_factor=0.2, max_factor=10.0):
    factor = jnp.where(
        ratio <= 1e-10,  # near-zero error: grow at max rate
        max_factor,
        jnp.clip(safety * ratio ** (-1.0 / order), min_factor, max_factor),
    )
    return dt * factor


def _initial_step_size(rhs, t0, y0, f0, args, order, rtol, atol):
    """Hairer-Nørsett-Wanner automatic initial step selection."""
    def scaled_norm(tree, ref):
        sq, n = 0.0, 0
        for x, r in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(ref)):
            scale = atol + rtol * jnp.abs(r)
            sq = sq + jnp.sum((x / scale) ** 2)
            n += x.size
        return jnp.sqrt(sq / n)

    d0 = scaled_norm(y0, y0)
    d1 = scaled_norm(f0, y0)
    h0 = jnp.where((d0 < 1e-5) | (d1 < 1e-5), 1e-6,
                   0.01 * d0 / jnp.maximum(d1, 1e-30))
    y1 = _tree_add_scaled(y0, h0, f0)
    f1 = rhs(t0 + h0, y1, args)
    d2 = scaled_norm(map_tree(lambda a, b: a - b, f1, f0), y0) / h0
    h1 = jnp.where(
        (d1 <= 1e-15) & (d2 <= 1e-15),
        jnp.maximum(1e-6, h0 * 1e-3),
        (0.01 / jnp.maximum(jnp.maximum(d1, d2), 1e-30)) ** (1.0 / (order + 1.0)),
    )
    return jnp.minimum(100.0 * h0, h1)


def _hermite_eval(t0, y0, f0, t1, y1, f1, t):
    """Cubic Hermite interpolant over [t0, t1] evaluated at ``t`` (pytrees)."""
    h = t1 - t0
    theta = (t - t0) / h
    th2 = theta * theta
    th3 = th2 * theta
    c_y0 = 2.0 * th3 - 3.0 * th2 + 1.0
    c_f0 = h * (th3 - 2.0 * th2 + theta)
    c_y1 = -2.0 * th3 + 3.0 * th2
    c_f1 = h * (th3 - th2)
    return map_tree(
        lambda a, da, b, db: c_y0 * a + c_f0 * da + c_y1 * b + c_f1 * db,
        y0, f0, y1, f1)


def _odeint_adaptive_fwd(rhs, tab, rtol, atol, max_steps, y0, ts, args,
                         interpolate: bool = True, collect_dt: bool = False):
    f0 = rhs(ts[0], y0, args)
    dt0 = _initial_step_size(rhs, ts[0], y0, f0, args, tab.order, rtol, atol)

    if not interpolate:
        # tstop semantics: steps clamped to land exactly on each save point
        def interval(carry, target_t):
            def cond(state):
                _, _, t, _, n = state
                return (t < target_t) & (n < max_steps)

            def body(state):
                y, f, t, dt, n = state
                dt_c = jnp.minimum(dt, target_t - t)
                y1, err, f_last = _rk_step(rhs, tab, t, y, dt_c, f, args)
                ratio = _error_ratio(err, y, y1, rtol, atol)
                accept = ratio <= 1.0
                f1 = f_last if tab.fsal else rhs(t + dt_c, y1, args)
                y = _tree_where(accept, y1, y)
                f = _tree_where(accept, f1, f)
                t = jnp.where(accept, t + dt_c, t)
                dt = _optimal_dt(dt_c, ratio, tab.order)
                return y, f, t, dt, n + 1

            y, f, t, dt, n = lax.while_loop(cond, body, carry)
            return (y, f, t, dt, n), y

        init = (y0, f0, ts[0], dt0, jnp.zeros((), jnp.int32))

        def scan_body(carry, target_t):
            y, f, t, dt, _ = carry
            dt_in = dt  # controller dt entering the interval (adjoint replay)
            carry, y_out = interval((y, f, t, dt, jnp.zeros((), jnp.int32)),
                                    target_t)
            return carry, (y_out, dt_in)

        _, (ys_tail, dt_ins) = lax.scan(scan_body, init, ts[1:])
        ys = map_tree(
            lambda first, rest: jnp.concatenate([first[None], rest], axis=0),
            y0, ys_tail)
        if collect_dt:
            return ys, dt_ins
        return ys

    # Dense output: free stepping (the controller's dt is never clamped to a
    # save point), save values read off a cubic Hermite interpolant over the
    # last accepted step — DiffEq's ``saveat`` semantics (reference
    # docs/src/tutorials/VMH.md:87). One free step may cross several save
    # points: the while-loop then runs zero iterations for the later ones and
    # the same step's interpolant serves them all.
    def interval(carry, target_t):
        def cond(state):
            _, _, _, t, _, _, _, n = state
            return (t < target_t) & (n < max_steps)

        def body(state):
            tp, yp, fp, t, y, f, dt, n = state
            y1, err, f_last = _rk_step(rhs, tab, t, y, dt, f, args)
            ratio = _error_ratio(err, y, y1, rtol, atol)
            accept = ratio <= 1.0
            f1 = f_last if tab.fsal else rhs(t + dt, y1, args)
            tp = jnp.where(accept, t, tp)
            yp = _tree_where(accept, y, yp)
            fp = _tree_where(accept, f, fp)
            y = _tree_where(accept, y1, y)
            f = _tree_where(accept, f1, f)
            t = jnp.where(accept, t + dt, t)
            dt = _optimal_dt(dt, ratio, tab.order)
            return tp, yp, fp, t, y, f, dt, n + 1

        state = lax.while_loop(cond, body, carry)
        tp, yp, fp, t, y, f, dt, _ = state
        y_save = _hermite_eval(tp, yp, fp, t, y, f, target_t)
        return state, y_save

    init = (ts[0], y0, f0, ts[0], y0, f0, dt0, jnp.zeros((), jnp.int32))

    def scan_body(carry, target_t):
        tp, yp, fp, t, y, f, dt, _ = carry
        carry, y_out = interval(
            (tp, yp, fp, t, y, f, dt, jnp.zeros((), jnp.int32)), target_t)
        return carry, y_out

    _, ys_tail = lax.scan(scan_body, init, ts[1:])
    return map_tree(
        lambda first, rest: jnp.concatenate([first[None], rest], axis=0),
        y0, ys_tail)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3, 4, 5))
def _odeint_adaptive(rhs, tab, rtol, atol, max_steps, interpolate, y0, ts,
                     args):
    return _odeint_adaptive_fwd(rhs, tab, rtol, atol, max_steps, y0, ts, args,
                                interpolate=interpolate)


def _fwd(rhs, tab, rtol, atol, max_steps, interpolate, y0, ts, args):
    ys = _odeint_adaptive_fwd(rhs, tab, rtol, atol, max_steps, y0, ts, args,
                              interpolate=interpolate)
    return ys, (ys, ts, args)


def _bwd(rhs, tab, rtol, atol, max_steps, interpolate, res, g):
    """Continuous backsolve adjoint (optimise-then-discretise), integrating
    the augmented system [y, ȳ, t̄, ārgs] backwards between save points —
    structurally the approach of jax.experimental.ode, adapted to the
    ``rhs(t, y, args)`` convention and pluggable tableaus."""
    ys, ts, args = res
    T = ts.shape[0]

    def aug_dynamics(s, aug, args):
        # s = -t (so s increases as we integrate backwards in t)
        y, y_bar, _, _ = aug
        y_dot, vjpfun = jax.vjp(lambda t, y, a: rhs(t, y, a), -s, y, args)
        t_bar_d, y_bar_d, args_bar_d = vjpfun(y_bar)
        return (map_tree(jnp.negative, y_dot), y_bar_d, -t_bar_d, args_bar_d)

    y_bar_T = map_tree(lambda l: l[-1], g)
    zero_args_bar = map_tree(jnp.zeros_like, args)

    def scan_fun(carry, i):
        y_bar, t0_bar, args_bar = carry
        y_i = map_tree(lambda l: l[i], ys)
        g_i = map_tree(lambda l: l[i], g)
        # dL/dt_i contribution: ⟨ȳ_i, f(t_i, y_i)⟩
        f_i = rhs(ts[i], y_i, args)
        t_bar = sum(
            jnp.sum(a * b) for a, b in zip(jax.tree_util.tree_leaves(g_i),
                                           jax.tree_util.tree_leaves(f_i)))
        t0_bar = t0_bar - t_bar
        aug0 = (y_i, y_bar, t0_bar, args_bar)
        span = jnp.stack([-ts[i], -ts[i - 1]])
        # backward sweeps always clamp to the span endpoint (exactness of the
        # adjoint endpoint matters more than the forced-step cost here)
        aug_T = _odeint_adaptive_fwd(aug_dynamics, tab, rtol, atol, max_steps,
                                     aug0, span, args, interpolate=False)
        _, y_bar, t0_bar, args_bar = map_tree(lambda l: l[-1], aug_T)
        y_bar = map_tree(lambda a, b: a + b,
                         y_bar, map_tree(lambda l: l[i - 1], g))
        return (y_bar, t0_bar, args_bar), t_bar

    init = (y_bar_T, jnp.zeros(()), zero_args_bar)
    (y_bar, t0_bar, args_bar), rev_ts_bar = lax.scan(
        scan_fun, init, jnp.arange(T - 1, 0, -1))
    ts_bar = jnp.concatenate([t0_bar[None], rev_ts_bar[::-1]])
    return (y_bar, ts_bar, args_bar)


_odeint_adaptive.defvjp(_fwd, _bwd)


# --------------------------------------------- checkpointed discrete adjoint
def _acc_cot(a, b):
    """Accumulate cotangents, tolerating float0 (integer-input) leaves."""
    if getattr(b, "dtype", None) == jax.dtypes.float0:
        return a
    return a + b


def _zero_cot(leaf):
    import numpy as np

    if jnp.issubdtype(leaf.dtype, jnp.integer) or leaf.dtype == jnp.bool_:
        return np.zeros(leaf.shape, jax.dtypes.float0)
    return jnp.zeros_like(leaf)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3, 4, 5, 6))
def _odeint_checkpoint(rhs, tab, rtol, atol, max_steps, chk_steps, interpolate,
                       y0, ts, args):
    return _odeint_adaptive_fwd(rhs, tab, rtol, atol, max_steps, y0, ts, args,
                                interpolate=interpolate)


def _chk_fwd(rhs, tab, rtol, atol, max_steps, chk_steps, interpolate, y0, ts,
             args):
    if interpolate:
        # Hermite saves: the whole free-stepping trajectory is reproduced by
        # a single replay from (ts[0], ys[0]) in the backward — nothing but
        # the outputs themselves need saving (dt0 is recomputed).
        ys = _odeint_adaptive_fwd(rhs, tab, rtol, atol, max_steps, y0, ts,
                                  args, interpolate=True)
        return ys, (ys, ts, args)
    ys, dt_ins = _odeint_adaptive_fwd(rhs, tab, rtol, atol, max_steps, y0, ts,
                                      args, interpolate=False,
                                      collect_dt=True)
    return ys, (ys, ts, args, dt_ins)


def _chk_bwd_hermite(rhs, tab, rtol, atol, max_steps, chk_steps, res, g):
    """Checkpointed discrete adjoint for the Hermite dense-output forward.

    The free-stepping forward never clamps its steps to save points, so the
    entire trajectory is one deterministic sequence of steps independent of
    ``ts[1:]``. The backward therefore does ONE global replay from
    ``(ts[0], ys[0])`` recording every accepted step ``(t_k, dt_k, y_k)``
    (buffer of ``chk_steps`` — here a bound on TOTAL accepted steps over the
    whole span, not per save interval), maps each save time to the accepted
    step whose interpolant produced it, and sweeps the steps in reverse.

    Key structural fact: the cubic Hermite save value is LINEAR in the step's
    four ingredients ``(y_k, f_k, y_{k+1}, f_{k+1})`` with scalar,
    time-only coefficients — so each save's cotangent enters the step VJP as
    a coefficient-weighted cotangent on those ingredients, and one
    ``jax.vjp`` per step pulls both the trajectory cotangent and all of that
    step's save cotangents back to ``(y_k, args)`` together.
    """
    ys, ts, args = res
    T = ts.shape[0]
    S = chk_steps

    y0 = map_tree(lambda l: l[0], ys)
    t0 = ts[0]
    t_final = ts[-1]
    f0 = rhs(t0, y0, args)
    dt0 = _initial_step_size(rhs, t0, y0, f0, args, tab.order, rtol, atol)

    # ---- global replay, recording accepted steps
    buf_t = jnp.zeros((S,), ts.dtype)
    buf_dt = jnp.zeros((S,), ts.dtype)
    buf_y = map_tree(lambda l: jnp.zeros((S,) + l.shape, l.dtype), y0)

    def cond(st):
        _, _, t, _, n_acc, n_tot, *_ = st
        return (t < t_final) & (n_tot < max_steps) & (n_acc < S)

    def body(st):
        y, f, t, dt, n_acc, n_tot, bt, bdt, by = st
        y1, err, f_last = _rk_step(rhs, tab, t, y, dt, f, args)
        ratio = _error_ratio(err, y, y1, rtol, atol)
        accept = ratio <= 1.0
        f1 = f_last if tab.fsal else rhs(t + dt, y1, args)
        bt = bt.at[n_acc].set(jnp.where(accept, t, bt[n_acc]))
        bdt = bdt.at[n_acc].set(jnp.where(accept, dt, bdt[n_acc]))
        by = map_tree(
            lambda b, l: b.at[n_acc].set(jnp.where(accept, l, b[n_acc])),
            by, y)
        y = _tree_where(accept, y1, y)
        f = _tree_where(accept, f1, f)
        t = jnp.where(accept, t + dt, t)
        dt = _optimal_dt(dt, ratio, tab.order)
        return (y, f, t, dt, n_acc + accept.astype(jnp.int32), n_tot + 1,
                bt, bdt, by)

    st = lax.while_loop(
        cond, body,
        (y0, f0, t0, dt0, jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
         buf_t, buf_dt, buf_y))
    _, _, t_fin, _, n_acc, _, bt, bdt, by = st
    ok = t_fin >= t_final

    # ---- save -> serving-step map (first accepted step reaching the save)
    t_ends = jnp.where(jnp.arange(S) < n_acc, bt + bdt,
                       jnp.full((S,), jnp.inf, ts.dtype))
    k_of = jnp.clip(jnp.searchsorted(t_ends, ts[1:], side="left"), 0, S - 1)

    # Hermite coefficients per save (scalars; the interpolant is linear in
    # the step ingredients with these weights — see _hermite_eval)
    hk = bdt[k_of]
    theta = (ts[1:] - bt[k_of]) / jnp.where(hk == 0, 1.0, hk)
    th2 = theta * theta
    th3 = th2 * theta
    c_y0 = 2.0 * th3 - 3.0 * th2 + 1.0
    c_f0 = hk * (th3 - 2.0 * th2 + theta)
    c_y1 = -2.0 * th3 + 3.0 * th2
    c_f1 = hk * (th3 - th2)

    g_tail = map_tree(lambda l: l[1:], g)

    def weighted(coefs, mask):
        w = coefs * mask
        return map_tree(
            lambda l: jnp.tensordot(w.astype(l.dtype), l, axes=(0, 0)),
            g_tail)

    zero_args_bar = map_tree(_zero_cot, args)
    y_bar = map_tree(lambda l: jnp.zeros_like(l[-1]), g)

    def back_step(c, k):
        y_bar, args_bar = c

        def do(c2):
            y_bar, args_bar = c2
            t_k, dt_k = bt[k], bdt[k]
            y_k = map_tree(lambda b: b[k], by)
            mask = (k_of == k).astype(ts.dtype)
            A = (weighted(c_y0, mask), weighted(c_f0, mask),
                 weighted(c_y1, mask), weighted(c_f1, mask))

            def step_and_ingredients(y, a):
                fp = rhs(t_k, y, a)
                y1, _, f_last = _rk_step(rhs, tab, t_k, y, dt_k, fp, a)
                f1 = f_last if tab.fsal else rhs(t_k + dt_k, y1, a)
                return y1, (y, fp, y1, f1)

            _, vjpf = jax.vjp(step_and_ingredients, y_k, args)
            yb, ab = vjpf((y_bar, A))
            return yb, map_tree(_acc_cot, args_bar, ab)

        return lax.cond(k < n_acc, do, lambda c2: c2,
                        (y_bar, args_bar)), None

    (y_bar, args_bar), _ = lax.scan(back_step, (y_bar, zero_args_bar),
                                    jnp.arange(S - 1, -1, -1))
    y_bar = map_tree(lambda a, b: a + b, y_bar, map_tree(lambda l: l[0], g))

    # ts cotangents: continuous boundary formula <g_i, f(t_i, y_i)> (same
    # convention as the tstop and backsolve paths)
    def t_bar_body(carry, i):
        y_i = map_tree(lambda l: l[i], ys)
        g_i = map_tree(lambda l: l[i], g)
        f_i = rhs(ts[i], y_i, args)
        t_bar = sum(
            jnp.sum(a * b) for a, b in zip(jax.tree_util.tree_leaves(g_i),
                                           jax.tree_util.tree_leaves(f_i)))
        return carry - t_bar, t_bar

    t0_bar, ts_tail_bar = lax.scan(t_bar_body, jnp.zeros((), ts.dtype),
                                   jnp.arange(1, T))

    def poison(l):
        if getattr(l, "dtype", None) == jax.dtypes.float0:
            return l
        return jnp.where(ok, l, jnp.nan)

    y_bar = map_tree(poison, y_bar)
    args_bar = map_tree(poison, args_bar)
    ts_bar = jnp.concatenate([t0_bar[None], ts_tail_bar])
    return (y_bar, ts_bar, args_bar)


def _chk_bwd(rhs, tab, rtol, atol, max_steps, chk_steps, interpolate, res, g):
    """Checkpointed discrete adjoint (discretise-then-optimise) — the
    bounded-memory replacement for the reference's
    ``InterpolatingAdjoint(autojacvec=ZygoteVJP())`` training stack
    (reference docs/src/tutorials/graph_node.md:54-66).

    Memory: O(``chk_steps`` x state) per save interval, O(saves x state)
    checkpoints (the forward's own output). Per interval (reverse order):

    1. *Replay* the adaptive forward from the saved state ``ys[i-1]`` with
       the recorded controller step size, recording each *accepted* step's
       ``(t, dt, y_start)`` into a fixed buffer. The replay re-executes the
       identical operations on identical inputs, so it reproduces the forward
       trajectory.
    2. Sweep the buffer backwards, pulling the cotangent through each RK
       step with ``jax.vjp`` (one step rematerialized at a time).

    Unlike the backsolve adjoint this never integrates the state backwards,
    so it stays stable on stiff/dissipative dynamics (diffusion!) where
    backsolve explodes exponentially. Gradients are exact for the discrete
    solution. ``ts`` cotangents use the continuous boundary formula
    (same convention as the backsolve path).

    If an interval needs more than ``chk_steps`` accepted steps the replay
    cannot represent it; the returned gradients are poisoned with NaN so the
    failure is visible (raise ``chk_steps`` or loosen tolerances).

    With ``interpolate=True`` (Hermite dense-output saves) dispatch goes to
    ``_chk_bwd_hermite`` — one global replay instead of per-interval replays.
    """
    if interpolate:
        return _chk_bwd_hermite(rhs, tab, rtol, atol, max_steps, chk_steps,
                                res, g)
    ys, ts, args, dt_ins = res
    T = ts.shape[0]
    S = chk_steps

    def step_fn(t, dt, y, a):
        f0 = rhs(t, y, a)
        y1, _, _ = _rk_step(rhs, tab, t, y, dt, f0, a)
        return y1

    def replay(y_i, t_i, dt_i, target_t):
        """Re-run one save interval, recording accepted steps."""
        buf_t = jnp.zeros((S,), ts.dtype)
        buf_dt = jnp.zeros((S,), ts.dtype)
        buf_y = map_tree(lambda l: jnp.zeros((S,) + l.shape, l.dtype), y_i)
        f_i = rhs(t_i, y_i, args)

        def cond(st):
            _, _, t, _, n_acc, n_tot, *_ = st
            return (t < target_t) & (n_tot < max_steps) & (n_acc < S)

        def body(st):
            y, f, t, dt, n_acc, n_tot, bt, bdt, by = st
            dt_c = jnp.minimum(dt, target_t - t)
            y1, err, f_last = _rk_step(rhs, tab, t, y, dt_c, f, args)
            ratio = _error_ratio(err, y, y1, rtol, atol)
            accept = ratio <= 1.0
            f1 = f_last if tab.fsal else rhs(t + dt_c, y1, args)
            bt = bt.at[n_acc].set(jnp.where(accept, t, bt[n_acc]))
            bdt = bdt.at[n_acc].set(jnp.where(accept, dt_c, bdt[n_acc]))
            by = map_tree(
                lambda b, l: b.at[n_acc].set(jnp.where(accept, l, b[n_acc])),
                by, y)
            y = _tree_where(accept, y1, y)
            f = _tree_where(accept, f1, f)
            t = jnp.where(accept, t + dt_c, t)
            dt = _optimal_dt(dt_c, ratio, tab.order)
            return (y, f, t, dt, n_acc + accept.astype(jnp.int32), n_tot + 1,
                    bt, bdt, by)

        st = lax.while_loop(cond, body,
                            (y_i, f_i, t_i, dt_i,
                             jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
                             buf_t, buf_dt, buf_y))
        _, _, t_end, _, n_acc, _, bt, bdt, by = st
        complete = t_end >= target_t
        return bt, bdt, by, n_acc, complete

    y_bar_T = map_tree(lambda l: l[-1], g)
    zero_args_bar = map_tree(_zero_cot, args)

    def interval_bwd(carry, i):
        y_bar, t0_bar, args_bar, ok = carry
        y_start = map_tree(lambda l: l[i - 1], ys)
        g_i = map_tree(lambda l: l[i], g)
        # continuous boundary term dL/dt_i = <g_i, f(t_i, y_i)>
        y_i = map_tree(lambda l: l[i], ys)
        f_i = rhs(ts[i], y_i, args)
        t_bar = sum(
            jnp.sum(a * b) for a, b in zip(jax.tree_util.tree_leaves(g_i),
                                           jax.tree_util.tree_leaves(f_i)))
        t0_bar = t0_bar - t_bar

        bt, bdt, by, n_acc, complete = replay(y_start, ts[i - 1],
                                              dt_ins[i - 1], ts[i])
        ok = ok & complete

        def back_step(c, k):
            y_bar, args_bar = c

            def do(c2):
                y_bar, args_bar = c2
                t_k, dt_k = bt[k], bdt[k]
                y_k = map_tree(lambda b: b[k], by)
                _, vjpf = jax.vjp(
                    lambda y, a: step_fn(t_k, dt_k, y, a), y_k, args)
                yb, ab = vjpf(y_bar)
                return yb, map_tree(_acc_cot, args_bar, ab)

            return lax.cond(k < n_acc, do, lambda c2: c2,
                            (y_bar, args_bar)), None

        (y_bar, args_bar), _ = lax.scan(back_step, (y_bar, args_bar),
                                        jnp.arange(S - 1, -1, -1))
        y_bar = map_tree(lambda a, b: a + b, y_bar,
                         map_tree(lambda l: l[i - 1], g))
        return (y_bar, t0_bar, args_bar, ok), t_bar

    init = (y_bar_T, jnp.zeros((), ts.dtype), zero_args_bar,
            jnp.ones((), jnp.bool_))
    (y_bar, t0_bar, args_bar, ok), rev_ts_bar = lax.scan(
        interval_bwd, init, jnp.arange(T - 1, 0, -1))

    # chk_steps overflow poisons the gradients (visible failure, never wrong
    # numbers): NaN every inexact leaf.
    def poison(l):
        if getattr(l, "dtype", None) == jax.dtypes.float0:
            return l
        return jnp.where(ok, l, jnp.nan)

    y_bar = map_tree(poison, y_bar)
    args_bar = map_tree(poison, args_bar)
    ts_bar = jnp.concatenate([t0_bar[None], rev_ts_bar[::-1]])
    return (y_bar, ts_bar, args_bar)


_odeint_checkpoint.defvjp(_chk_fwd, _chk_bwd)


def odeint(
    rhs: Callable,
    y0: Any,
    ts: jax.Array,
    args: Any = None,
    *,
    solver="tsit5",
    rtol: float = 1e-6,
    atol: float = 1e-6,
    max_steps: int = 10_000,
    interpolation: str = "hermite",
    adjoint: str = "backsolve",
    checkpoint_steps: int = 128,
) -> Any:
    """Adaptive solve saving at ``ts`` (``ts[0]`` is the initial time).

    ``interpolation="hermite"`` (default): the controller steps freely and
    save values come from the cubic Hermite dense output of the step that
    crosses each save point — DiffEq ``saveat`` semantics, no forced step
    endpoints (important when save points are dense, e.g. rollout training).
    The interpolant is 3rd-order: per-save error is O(dt_step^4), which can
    exceed ``rtol`` when the controller takes large steps over easy dynamics;
    use ``interpolation="tstop"`` (steps clamped to land exactly on each
    save point) when save values must carry full solver accuracy.

    Adjoints (reverse mode):

    - ``adjoint="checkpoint"`` (recommended for training): checkpointed
      discrete adjoint — replays the trajectory and backpropagates
      step-by-step. Stable on stiff/dissipative dynamics (diffusion); exact
      gradients of the discrete solution. The analog of the reference's
      ``InterpolatingAdjoint(autojacvec=ZygoteVJP())``
      (docs/src/tutorials/graph_node.md:54-66). Honors both interpolation
      modes: with ``"tstop"``, replay is per save interval and
      ``checkpoint_steps`` bounds accepted steps *per interval*; with
      ``"hermite"`` (free stepping, dense-output saves) replay is one global
      sweep and ``checkpoint_steps`` bounds accepted steps over the *whole
      span*. Overflow poisons gradients with NaN (visible failure).
    - ``adjoint="backsolve"`` (the classic neural-ODE adjoint): continuous
      backsolve, O(1) memory in steps, but integrates the state backwards —
      exponentially unstable when the dynamics are dissipative over long
      spans.
    """
    if interpolation not in ("hermite", "tstop"):
        raise ValueError("interpolation must be 'hermite' or 'tstop'")
    if adjoint not in ("backsolve", "checkpoint"):
        raise ValueError("adjoint must be 'backsolve' or 'checkpoint'")
    tab = get_tableau(solver)
    if not tab.adaptive:
        raise ValueError(
            f"solver {tab.name!r} has no embedded error estimate; use "
            "odeint_grid for fixed-step solvers")
    ts = jnp.asarray(ts)
    if args is None:
        args = ()
    # custom_vjp treats ``rhs`` as static: hoist any traced values it closes
    # over (e.g. the graph arrays in a layer's state) into explicit arguments.
    converted, consts = jax.closure_convert(rhs, ts[0], y0, args)

    def rhs2(t, y, packed):
        inner_args, consts = packed
        return converted(t, y, inner_args, *consts)

    if adjoint == "checkpoint":
        return _odeint_checkpoint(rhs2, tab, rtol, atol, max_steps,
                                  checkpoint_steps,
                                  interpolation == "hermite", y0, ts,
                                  (args, consts))
    return _odeint_adaptive(rhs2, tab, rtol, atol, max_steps,
                            interpolation == "hermite", y0, ts,
                            (args, consts))


def solve_stats(
    rhs: Callable,
    y0: Any,
    ts: jax.Array,
    args: Any = None,
    *,
    solver="tsit5",
    rtol: float = 1e-6,
    atol: float = 1e-6,
    max_steps: int = 10_000,
):
    """Diagnostic forward solve returning ``(ys, attempts_per_interval)`` —
    attempts counts accepted+rejected steps per save interval (the RHS/SpMM
    invocation count driving the edges/s roofline; SURVEY §5.1)."""
    tab = get_tableau(solver)
    ts = jnp.asarray(ts)
    if args is None:
        args = ()
    f0 = rhs(ts[0], y0, args)
    dt0 = _initial_step_size(rhs, ts[0], y0, f0, args, tab.order, rtol, atol)

    def interval(carry, target_t):
        y, f, t, dt = carry

        def cond(state):
            _, _, t, _, n = state
            return (t < target_t) & (n < max_steps)

        def body(state):
            y, f, t, dt, n = state
            dt_c = jnp.minimum(dt, target_t - t)
            y1, err, f_last = _rk_step(rhs, tab, t, y, dt_c, f, args)
            ratio = _error_ratio(err, y, y1, rtol, atol)
            accept = ratio <= 1.0
            f1 = f_last if tab.fsal else rhs(t + dt_c, y1, args)
            y = _tree_where(accept, y1, y)
            f = _tree_where(accept, f1, f)
            t = jnp.where(accept, t + dt_c, t)
            dt = _optimal_dt(dt_c, ratio, tab.order)
            return y, f, t, dt, n + 1

        y, f, t, dt, n = lax.while_loop(
            cond, body, (y, f, t, dt, jnp.zeros((), jnp.int32)))
        return (y, f, t, dt), (y, n)

    init = (y0, f0, ts[0], dt0)
    _, (ys_tail, attempts) = lax.scan(interval, init, ts[1:])
    ys = map_tree(
        lambda first, rest: jnp.concatenate([first[None], rest], axis=0),
        y0, ys_tail)
    return ys, attempts
