"""Training loop: jitted step, metrics, checkpointing hooks.

Library-code promotion of the reference's tutorial training loops
(``Zygote.pullback`` + ``Optimisers.update`` per epoch, reference
docs/src/tutorials/graph_node.md:118-135, VMH.md:125-148).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional

import jax
import optax


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def make_train_step(loss_fn: Callable, optimizer: optax.GradientTransformation,
                    has_aux: bool = False, donate: bool = True):
    """Build a jitted ``(params, opt_state, *batch) -> (params, opt_state,
    loss[, aux])`` step. ``loss_fn(params, *batch)``."""

    def step(params, opt_state, *batch):
        if has_aux:
            (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                params, *batch)
        else:
            loss, grads = jax.value_and_grad(loss_fn)(params, *batch)
            aux = None
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss, aux

    return jax.jit(step, donate_argnums=(0, 1) if donate else ())


def make_train_step_dp(
    loss_fn: Callable,
    optimizer: optax.GradientTransformation,
    mesh=None,
    axis_name: str = "batch",
):
    """Data-parallel train step over the leading batch axis (SURVEY §2.3 DP
    plan): parameters/optimizer state replicated, every batch argument
    sharded on ``axis_name``, gradients averaged by XLA's GSPMD partitioner
    (the mean over the batch inserts the all-reduce — no hand-rolled
    pmap/psum).

    Per-sample graphs must share one structure, matching the reference's
    batching constraint (docs/src/index.md:66). Returns ``(step, mesh)``;
    ``step(params, opt_state, *batch)`` like ``make_train_step``. Batch
    leading dims must be divisible by the mesh size.
    """
    import numpy as np
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    if mesh is None:
        mesh = Mesh(np.asarray(jax.devices()), (axis_name,))

    repl = NamedSharding(mesh, P())
    batch_sh = NamedSharding(mesh, P(axis_name))

    def step(params, opt_state, *batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, *batch)
        updates, new_opt = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, new_opt, loss, None

    def shardings_like(tree, sh):
        return jax.tree_util.tree_map(lambda _: sh, tree)

    def wrapped(params, opt_state, *batch):
        f = jax.jit(
            step,
            in_shardings=(shardings_like(params, repl),
                          shardings_like(opt_state, repl))
            + tuple(shardings_like(b, batch_sh) for b in batch),
            out_shardings=(shardings_like(params, repl),
                           shardings_like(opt_state, repl), repl, None),
        )
        with mesh:
            return f(params, opt_state, *batch)

    return wrapped, mesh


@dataclasses.dataclass
class MetricsLogger:
    """Minimal metrics sink: in-memory history + optional JSONL file
    (SURVEY §5.5 observability plan)."""

    path: Optional[str] = None
    history: List[Dict] = dataclasses.field(default_factory=list)
    _t0: float = dataclasses.field(default_factory=time.time)

    def log(self, step: int, **metrics):
        rec = {"step": step, "wall_time": time.time() - self._t0}
        rec.update({k: float(v) for k, v in metrics.items()})
        self.history.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec


class StepHeartbeat:
    """Wall-clock watchdog around the jitted train step (SURVEY §5.3
    failure-detection plan). The training loop calls ``beat()`` at every
    step boundary (after the loss sync, so a beat proves the DEVICE made
    progress); a daemon thread fires ``on_stall(gap_seconds)`` whenever no
    beat lands within ``timeout_s`` — e.g. a hung device execute. The
    default action prints a diagnostic; pass ``on_stall=abort_on_stall`` to
    crash the process so a supervisor restarts it from the latest
    checkpoint."""

    def __init__(self, timeout_s: float, on_stall: Optional[Callable] = None,
                 poll_s: Optional[float] = None):
        import threading

        self.timeout_s = float(timeout_s)
        self.on_stall = on_stall or self._default_on_stall
        self._poll_s = poll_s if poll_s is not None else \
            max(self.timeout_s / 4, 0.01)
        # monotonic: an NTP step must not fake a stall (abort_on_stall
        # would os._exit a healthy run) or mask a real one
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.stalls = 0

    @staticmethod
    def _default_on_stall(gap: float):
        import sys

        print(f"[heartbeat] no step boundary for {gap:.1f}s — device "
              "execute may be hung", file=sys.stderr, flush=True)

    def beat(self):
        self._last = time.monotonic()

    def _run(self):
        while not self._stop.wait(self._poll_s):
            gap = time.monotonic() - self._last
            if gap > self.timeout_s:
                self.stalls += 1
                self.on_stall(gap)
                self._last = time.monotonic()  # re-arm

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        return False


def abort_on_stall(gap: float):
    """``StepHeartbeat`` action for supervised runs: crash NOW (exit 86) so
    the supervisor restarts from the latest checkpoint instead of the run
    hanging until an external watchdog loses hours."""
    import os
    import sys

    print(f"[heartbeat] aborting: no step boundary for {gap:.1f}s",
          file=sys.stderr, flush=True)
    sys.stderr.flush()
    os._exit(86)


def fit(
    loss_fn: Callable,
    params: Any,
    optimizer: optax.GradientTransformation,
    batches,
    *,
    epochs: int = 1,
    eval_fn: Optional[Callable] = None,
    logger: Optional[MetricsLogger] = None,
    log_every: int = 1,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    grad_clip: Optional[float] = None,
    nan_guard: bool = False,
    heartbeat_timeout: Optional[float] = None,
    on_stall: Optional[Callable] = None,
) -> TrainState:
    """Generic fit: ``batches`` is an iterable (re-iterated per epoch) of
    argument tuples passed to ``loss_fn(params, *batch)``.

    With ``checkpoint_dir`` set, ``(params, opt_state, step)`` are persisted
    every ``checkpoint_every`` epochs (and at the end); ``resume=True``
    restarts from the latest checkpoint — the standard restart-from-checkpoint
    failure-recovery scheme (SURVEY §5.3: fixed mesh, no elasticity). Resume
    is EXACT: the restored step count skips the already-trained leading
    batches, so a killed-and-resumed run takes the same optimizer path as an
    uninterrupted one (tests/test_train.py fault-injection case).

    ``heartbeat_timeout`` arms a :class:`StepHeartbeat` wall-clock watchdog
    for the duration of the fit (``on_stall`` as its action) — step
    boundaries beat it after the loss sync, so it detects hung device
    executes, not just slow Python.

    ``grad_clip`` chains global-norm clipping in front of the optimizer;
    ``nan_guard=True`` raises ``FloatingPointError`` on a non-finite loss
    (the batch index is in the message) instead of silently training on.
    """
    import contextlib
    import math

    if grad_clip is not None:
        optimizer = optax.chain(optax.clip_by_global_norm(grad_clip),
                                optimizer)
    opt_state = optimizer.init(params)
    step = 0
    if resume and checkpoint_dir:
        from .checkpoint import latest_step, restore_checkpoint

        if latest_step(checkpoint_dir) is not None:
            payload = restore_checkpoint(
                checkpoint_dir,
                {"params": params, "opt_state": opt_state, "step": 0})
            params, opt_state = payload["params"], payload["opt_state"]
            step = int(payload["step"])
    train_step = make_train_step(loss_fn, optimizer, donate=False)
    logger = logger or MetricsLogger()
    hb = (StepHeartbeat(heartbeat_timeout, on_stall)
          if heartbeat_timeout else contextlib.nullcontext())
    global_idx = 0  # batches seen across epochs, INCLUDING skipped ones
    with hb:
        for epoch in range(epochs):
            loss_sum, n_batches, any_yield = 0.0, 0, False
            for batch in batches:
                any_yield = True
                if global_idx < step:  # trained before the resume point
                    global_idx += 1
                    continue
                params, opt_state, loss, _ = train_step(
                    params, opt_state, *batch)
                global_idx += 1
                step = global_idx
                n_batches += 1
                loss_f = float(loss)
                if heartbeat_timeout:
                    hb.beat()
                if nan_guard and not math.isfinite(loss_f):
                    raise FloatingPointError(
                        f"non-finite loss {loss_f} at epoch {epoch + 1}, "
                        f"batch {n_batches} (step {step})")
                loss_sum += loss_f
            if not any_yield:
                raise ValueError("fit(): `batches` yielded no batches")
            if n_batches == 0:
                continue  # epoch fully covered by the restored checkpoint
            if (epoch + 1) % log_every == 0:
                metrics = {"loss": loss_sum / n_batches, "epoch": epoch + 1}
                if eval_fn is not None:
                    metrics.update(eval_fn(params))
                logger.log(step, **metrics)
            if checkpoint_dir and checkpoint_every and \
                    (epoch + 1) % checkpoint_every == 0:
                from .checkpoint import save_checkpoint

                save_checkpoint(checkpoint_dir, params, opt_state, step)
    if checkpoint_dir:
        from .checkpoint import save_checkpoint

        save_checkpoint(checkpoint_dir, params, opt_state, step)
    return TrainState(params=params, opt_state=opt_state, step=step)
