#!/usr/bin/env python3
"""On-card smoke test: the main paths at published widths, each compared
with the plain reference, on one NVIDIA GPU.

    python chip_smoke.py            # one card: every single-card phase
    python chip_smoke.py --multi    # four cards: the edge-partitioned phases

Phases (one card):

- ``card_tests``: the GPU-marked pytest tier (``tests/test_gpu_compiled.py``).
- ``gcn_ode/{grid,reord,rand}``: two Adam steps of ``grand_model`` (F=128,
  tanh, Tsit5, checkpointed adjoint) on the three graphs that select the
  aggregation paths: the 512×512 8-neighbour grid (DIA stencil), a
  131,072-point Delaunay mesh with scrambled labels under
  ``auto_reorder=True`` (gather on the RCM-relabeled mesh), and a random
  graph with 2^18 nodes and degree 16 (gather); then the loss and gradient
  in f32 and under ``bf16(model)``.
- ``vmh``: the reference VMH protocol of ``examples/train_vmh.py`` (24 sims ×
  3000 Delaunay nodes, ϕ 4→60→60→60→40, γ 41→60→60→60→1, Tsit5 rtol 1e-5,
  checkpointed adjoint, Rprop, accum=4), two epochs.

Phases (four cards, ``--multi``): a sharded GRAND train step on a ≥10M-edge
strip-partitioned grid and a ``ShardedVMHConv`` ODE train step, each against
the same model on one device.

Every phase prints its largest error against the reference, the tolerance
and the matmul precision of both sides, the compiled step's
``memory_analysis()`` and the device's ``peak_bytes_in_use`` so far. The
reference is the plain XLA path (``set_spmm_mode("xla")``) in float32 under
``jax.default_matmul_precision("highest")``. Errors are relative to the
reference's largest magnitude, per array ("max") or over all gradient
arrays together ("norm": ‖g − g_ref‖ / ‖g_ref‖). Tolerances:

- The path under test at ``highest`` precision vs the reference: 1e-3.
  Only the order of float32 sums differs (XLA's segment sums use atomics on
  the card), and adaptive steps may land differently by a few ulps.
- The path at default precision vs the reference: loss 2e-2 (max), gradient
  1e-1 (norm). Default-precision float32 products run in TF32 on this card
  (10-bit mantissa, unit roundoff 2^-11 ≈ 4.9e-4). The loss sees that
  directly; parameter gradients sum 10^5–10^6 node terms of both signs, so
  the cancellation amplifies the relative error, and a perturbed RHS moves
  the adaptive solver's accepted steps, which changes the discrete adjoint's
  gradient at the order of its rtol (1e-3).
- ``bf16(model)`` (the GCN phases: bf16 compute, f32 master parameters) vs
  the reference: loss 2e-2 (max), gradient 2e-1 (norm). bf16's unit
  roundoff is 2^-8 ≈ 3.9e-3, 8× TF32's; the same cancellation and step
  changes apply. CPU rehearsals at reduced size (64² and 128² grids, a
  scrambled 8192-point Delaunay mesh, random graphs; F=32 and 128) gave
  losses within 5.2e-4 and gradients within 2.9e-2–5.2e-2 (norm), so the
  limits leave a margin of about 4× or more.

The last line is one JSON object: ``{"ok": true, "device": {...}}``. The
script exits non-zero, and prints no such line, when JAX finds no GPU or a
phase fails.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TOL_PATH = 1e-3
TOL_TF32_LOSS = 2e-2
TOL_TF32_GRAD = 1e-1
TOL_BF16_LOSS = 2e-2
TOL_BF16_GRAD = 2e-1


def rel_err(got, want) -> float:
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"shape {got.shape} != {want.shape}")
    if not np.all(np.isfinite(got)):
        raise AssertionError("non-finite values")
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-30))


def tree_rel_err(got, want) -> float:
    """Largest per-array ``rel_err`` over a tree."""
    import jax

    return max(rel_err(a, b) for a, b in zip(jax.tree_util.tree_leaves(got),
                                             jax.tree_util.tree_leaves(want)))


def tree_norm_err(got, want) -> float:
    """``‖got − want‖ / ‖want‖`` over all arrays of a tree together."""
    import jax
    import numpy as np

    pairs = [(np.asarray(a, np.float64), np.asarray(b, np.float64))
             for a, b in zip(jax.tree_util.tree_leaves(got),
                             jax.tree_util.tree_leaves(want))]
    if not all(np.all(np.isfinite(a)) for a, _ in pairs):
        raise AssertionError("non-finite values")
    num = sum(float(np.sum((a - b) ** 2)) for a, b in pairs)
    den = sum(float(np.sum(b ** 2)) for _, b in pairs)
    return (num / max(den, 1e-300)) ** 0.5


def memory_report(fn, *args) -> str:
    """``memory_analysis()`` of the compiled ``fn(*args)`` and the device's
    peak bytes so far."""
    import jax

    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    ma = jitted.lower(*args).compile().memory_analysis()
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    if ma is None:
        return f"memory_analysis=None peak_bytes_in_use={peak}"
    return (f"memory_analysis: args={ma.argument_size_in_bytes} "
            f"out={ma.output_size_in_bytes} temp={ma.temp_size_in_bytes} "
            f"code={ma.generated_code_size_in_bytes} | "
            f"peak_bytes_in_use={peak}")


class Phases:
    def __init__(self):
        self.failed = []

    def run(self, name, fn, *args, **kwargs):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn(*args, **kwargs)
            print(f"   {name}: ok ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        except Exception as err:  # report every phase, then fail the run
            import traceback

            traceback.print_exc()
            print(f"   {name}: FAILED {type(err).__name__}: {err}",
                  flush=True)
            self.failed.append(name)


def compare(name, main, ref, main_bf16=None):
    """``main()`` and ``ref()`` each return ``(loss, grads)``. Checks the
    path under test at highest precision, then at default precision, and
    ``main_bf16()`` (the model under ``bf16``) when given, against the
    plain XLA reference at highest precision."""
    import jax

    from neuralgraphpde.ops import set_spmm_mode

    with jax.default_matmul_precision("highest"):
        set_spmm_mode("xla")
        try:
            loss_ref, grads_ref = ref()
        finally:
            set_spmm_mode("auto")
        loss_hi, grads_hi = main()
    loss, grads = main()
    check(f"{name} loss, path", rel_err(loss_hi, loss_ref), TOL_PATH,
          "highest vs reference highest")
    check(f"{name} grads, path (max)", tree_rel_err(grads_hi, grads_ref),
          TOL_PATH, "highest vs reference highest")
    check(f"{name} loss, default precision", rel_err(loss, loss_ref),
          TOL_TF32_LOSS, "default (TF32) vs reference highest")
    print(f"   {name} grads, default precision (max): "
          f"{tree_rel_err(grads, grads_ref):.3e}")
    check(f"{name} grads, default precision (norm)",
          tree_norm_err(grads, grads_ref), TOL_TF32_GRAD,
          "default (TF32) vs reference highest")
    if main_bf16 is None:
        return
    loss_b, grads_b = main_bf16()
    check(f"{name} loss, bf16(model)", rel_err(loss_b, loss_ref),
          TOL_BF16_LOSS, "bf16 vs reference highest")
    print(f"   {name} grads, bf16(model) (max): "
          f"{tree_rel_err(grads_b, grads_ref):.3e}")
    check(f"{name} grads, bf16(model) (norm)",
          tree_norm_err(grads_b, grads_ref), TOL_BF16_GRAD,
          "bf16 vs reference highest")


def check(name, err, tol, precision):
    print(f"   {name}: rel_err={err:.3e} tol={tol:.0e} "
          f"precision={precision}", flush=True)
    if not err <= tol:
        raise AssertionError(f"{name}: error {err:.3e} above {tol:.0e}")


# ------------------------------------------------------------ card tests
def phase_card_tests():
    """The card-marked pytest tier, in this process (a second process
    could not get the card's memory)."""
    import pytest

    os.environ["NGPDE_TEST_ON_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests", "test_gpu_compiled.py")])
    if rc != 0:
        raise AssertionError(f"card tests exited {rc}")


# --------------------------------------------------------- GCN neural ODE
def gcn_graph(kind, scale=1):
    import numpy as np

    from neuralgraphpde.graph.builders import (delaunay_graph, grid_graph_2d,
                                               rand_graph)

    if kind == "grid":
        return grid_graph_2d(512 // scale, 512 // scale, diagonals=True), {}
    if kind == "reord":
        pts = np.random.default_rng(0).random(((1 << 17) // scale ** 2, 2))
        return delaunay_graph(pts), {"auto_reorder": True}
    n = (1 << 18) // scale ** 2
    return rand_graph(n, 16 * n, seed=0), {}


def phase_gcn_ode(kind, feat=128, classes=8, steps=2, scale=1):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from neuralgraphpde import bf16, precompute, setup, update_graph
    from neuralgraphpde.models import grand_model

    g0, kw = gcn_graph(kind, scale)
    g = precompute(g0, add_self_loops=True, **kw)
    print(f"   {kind}: nodes={g.num_nodes} edges={g.num_edges} "
          f"cache={sorted(k for k in g.cache if k not in ('orig_edge_pos',))}")
    if kind == "grid" and "dia" not in g.cache:
        raise AssertionError("grid did not take the DIA path")
    if kind == "reord" and "node_order" not in g.cache:
        raise AssertionError("auto_reorder did not relabel the mesh")
    model = grand_model(feat, feat, classes, precomputed_self_loops=True)
    ps0, st = setup(jax.random.PRNGKey(0), model)
    st = update_graph(st, g)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(g.num_nodes, feat)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, classes, g.num_nodes))
    opt = optax.adam(1e-3)

    # labels, like the graph, go in as arguments: closed-over arrays would
    # be compiled in as constants
    def loss_fn(ps, x, st, labels, model=model):
        logits, _ = model(x, ps, st)
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=-1))

    def step(ps, opt_state, x, st, labels):
        loss, grads = jax.value_and_grad(loss_fn)(ps, x, st, labels)
        upd, opt_state = opt.update(grads, opt_state, ps)
        return optax.apply_updates(ps, upd), opt_state, loss, grads

    step_main = jax.jit(step)
    ps, opt_state = ps0, opt.init(ps0)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        ps, opt_state, loss, _ = step_main(ps, opt_state, x, st, labels)
        losses.append(float(loss))
        if i == 0:
            print(f"   first step (compile + run) "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"   losses {losses}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError("non-finite loss")

    value_and_grad = lambda: jax.jit(jax.value_and_grad(loss_fn))(
        ps0, x, st, labels)
    # same parameters (the wrapper has one child); its state nests the model's
    model_bf16 = bf16(model)
    value_and_grad_bf16 = lambda: jax.jit(jax.value_and_grad(
        functools.partial(loss_fn, model=model_bf16)))(
            ps0, x, {"layer": st}, labels)
    compare(f"gcn_ode/{kind}", value_and_grad, value_and_grad,
            value_and_grad_bf16)
    print("   " + memory_report(step_main, ps0, opt.init(ps0), x, st, labels))


# ------------------------------------------------------------------- VMH
def phase_vmh(epochs=2, **cfg_kw):
    import jax
    import numpy as np

    sys.path.insert(0, os.path.join(HERE, "examples"))
    import train_vmh

    cfg = train_vmh.Config(**cfg_kw)
    tr = train_vmh.setup(cfg)
    print(f"   vmh: sims={cfg.num_sims} nodes={tr.data.graph.num_nodes} "
          f"edges={tr.data.graph.num_edges} accum={cfg.accum}")
    ps, opt_state = tr.ps, tr.opt_state
    t0 = time.perf_counter()
    loss1, grads1 = train_vmh.epoch_gradient(tr, ps)
    print(f"   epoch 1 (compile + run) {time.perf_counter() - t0:.1f} s",
          flush=True)
    losses = [float(loss1)]
    acc = grads1
    for _ in range(epochs - 1):
        ps, opt_state = tr.apply_step(ps, opt_state, acc)
        t0 = time.perf_counter()
        loss, acc = train_vmh.epoch_gradient(tr, ps)
        losses.append(float(loss))
        print(f"   epoch {len(losses)} {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"   losses {losses}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError("non-finite loss")

    def epoch1():
        # a fresh setup traces under the current mode and precision
        return train_vmh.epoch_gradient(train_vmh.setup(cfg, data=tr.data),
                                        tr.ps)

    compare("vmh epoch 1", epoch1, epoch1)
    print("   " + memory_report(tr.micro_grad, tr.ps, grads1,
                                tr.u[:tr.mb], tr.st))


# ---------------------------------------------------------- four cards
def _distinct_devices(arr, want):
    devs = {s.device.id for s in arr.addressable_shards}
    print(f"   shards on devices {sorted(devs)}")
    if len(devs) != want:
        raise AssertionError(f"shards on {len(devs)} devices, want {want}")


def phase_multi_grand(ndev=4, nx=4096, ny=288, feat=64, classes=8):
    """Sharded GRAND train step on a strip-partitioned grid (the mesh shape
    of examples/weak_scaling.py) vs the same model on one device."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from neuralgraphpde import add_self_loops, precompute, setup, update_graph
    from neuralgraphpde.graph.builders import grid_graph_2d
    from neuralgraphpde.models import grand_model
    from neuralgraphpde.parallel import (make_mesh, pad_node_features,
                                         partition_graph, shard_node_features,
                                         sharded_grand_model)

    g = add_self_loops(grid_graph_2d(nx, ny, diagonals=True))
    mesh = make_mesh(ndev)
    pg = partition_graph(g, ndev, halo=True)
    print(f"   grid {nx}x{ny}: nodes={g.num_nodes} edges={g.num_edges} "
          f"partitions={ndev} dia={pg.dia_values is not None} "
          f"neighbor_only={pg.halo_neighbor_only}")
    rng = np.random.default_rng(0)
    x_np = rng.normal(size=(g.num_nodes, feat)).astype(np.float32)
    lab_np = rng.integers(0, classes, g.num_nodes)
    kw = dict(tspan=(0.0, 1.0), rtol=1e-3, atol=1e-3)
    sharded = sharded_grand_model(feat, feat, classes, mesh,
                                  initialgraph=lambda: pg, **kw)
    ps, st = setup(jax.random.PRNGKey(0), sharded)
    xs = shard_node_features(pad_node_features(x_np, pg), pg, mesh)
    _distinct_devices(xs, ndev)
    labels = jnp.asarray(lab_np)

    def xent(logits, labels):
        logp = jax.nn.log_softmax(logits[: g.num_nodes], axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=-1))

    # states (graphs) and labels go in as arguments: a closed-over array
    # would be compiled in as a constant
    def step(model):
        return jax.jit(jax.value_and_grad(
            lambda p, x, st, y: xent(model(x, p, st)[0], y)))

    single = grand_model(feat, feat, classes, precomputed_self_loops=True,
                         adjoint="checkpoint", **kw)
    _, st1 = setup(jax.random.PRNGKey(0), single)
    st1 = update_graph(st1, precompute(g))
    x1 = jnp.asarray(x_np)
    compare("multi/grand", lambda: step(sharded)(ps, xs, st, labels),
            lambda: step(single)(ps, x1, st1, labels))


def phase_multi_vmh(ndev=4, points=3000, hidden=60, msg=40):
    """ShardedVMHConv ODE train step vs VMHConv on one device."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from neuralgraphpde import MLP, VMHConv, precompute, setup, update_graph
    from neuralgraphpde.graph.builders import delaunay_graph
    from neuralgraphpde.ode.neural_ode import NeuralGraphODE
    from neuralgraphpde.parallel import (ShardedVMHConv, make_mesh,
                                         pad_node_features, partition_graph,
                                         shard_node_features)

    rng = np.random.default_rng(0)
    pts = rng.random((points, 2)).astype(np.float32)
    g = delaunay_graph(pts, ndata={"x": pts})
    mesh = make_mesh(ndev)
    pg = partition_graph(g, ndev, halo=True)
    phi = MLP((4, hidden, hidden, hidden, msg), "tanh")
    gamma = MLP((1 + msg, hidden, hidden, hidden, 1), "tanh")
    ode = dict(tspan=(0.0, 0.1), solver="tsit5", rtol=1e-5, atol=1e-3,
               output="last")
    sharded = NeuralGraphODE(ShardedVMHConv(phi, gamma, mesh=mesh,
                                            initialgraph=lambda: pg), **ode)
    single = NeuralGraphODE(VMHConv(phi, gamma), **ode)
    ps, st = setup(jax.random.PRNGKey(1), sharded)
    _, st1 = setup(jax.random.PRNGKey(1), single)
    st1 = update_graph(st1, precompute(g, dense=False))
    u = rng.normal(size=(points, 1)).astype(np.float32)
    us = shard_node_features(pad_node_features(u, pg), pg, mesh)
    _distinct_devices(us, ndev)

    def step(model):
        return jax.jit(jax.value_and_grad(
            lambda p, x, st: jnp.mean(model(x, p, st)[0][:points] ** 2)))

    compare("multi/vmh", lambda: step(sharded)(ps, us, st),
            lambda: step(single)(ps, jnp.asarray(u), st1))


def main(argv) -> int:
    multi = "--multi" in argv
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from neuralgraphpde.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    print(f"jax {jax.__version__}: {len(devices)} x {devices[0].device_kind}")
    ph = Phases()
    if multi:
        if len(devices) < 4:
            print(f"--multi needs 4 GPUs, found {len(devices)}",
                  file=sys.stderr)
            return 2
        ph.run("multi/grand", phase_multi_grand)
        ph.run("multi/vmh", phase_multi_vmh)
    else:
        ph.run("card_tests", phase_card_tests)
        for kind in ("grid", "reord", "rand"):
            ph.run(f"gcn_ode/{kind}", phase_gcn_ode, kind)
        ph.run("vmh", phase_vmh)
    if ph.failed:
        print(f"chip_smoke: failed phases: {ph.failed}", file=sys.stderr)
        return 1
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
