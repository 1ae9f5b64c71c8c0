"""Config 5 (BASELINE.json): GRAND diffusion on a large synthetic graph,
edge-partitioned across all available devices with halo exchange per RHS
evaluation. On a multi-host pod slice, run one process per host after
``jax.distributed.initialize()``; here it demonstrates the same program on
whatever device pool exists (8 virtual CPUs in tests, the GPUs of one host
on the card).

python examples/distributed_grand.py --cpu8 --nodes 20000 --degree 12
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np


def main(num_nodes: int, avg_degree: int, hidden: int = 64, classes: int = 16,
         steps: int = 5):
    import optax

    from neuralgraphpde import add_self_loops, setup
    from neuralgraphpde.data import random_spmm_graph
    from neuralgraphpde.parallel import (
        make_mesh, pad_node_features, partition_graph, shard_node_features,
        sharded_grand_model,
    )

    ndev = jax.device_count()
    mesh = make_mesh(ndev)
    print(f"devices: {ndev} ({jax.devices()[0].platform})")

    g, x_np = random_spmm_graph(num_nodes, avg_degree, hidden, seed=0)
    g = add_self_loops(g)
    t0 = time.time()
    pg = partition_graph(g, ndev)
    print(f"partitioned {g.num_edges} edges over {ndev} devices "
          f"in {time.time() - t0:.2f}s (max edges/part: "
          f"{pg.senders_global.shape[1]})")

    model = sharded_grand_model(hidden, hidden, classes, mesh,
                                initialgraph=lambda: pg, rtol=1e-2, atol=1e-2)
    ps, st = setup(jax.random.PRNGKey(0), model)
    x = shard_node_features(pad_node_features(x_np, pg), pg, mesh)
    labels = jnp.asarray(
        np.random.default_rng(0).integers(0, classes, size=g.num_nodes))

    opt = optax.adam(1e-3)
    opt_state = opt.init(ps)

    def loss_fn(ps, x):
        logits, _ = model(x, ps, st)
        logp = jax.nn.log_softmax(logits[: g.num_nodes], axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], axis=-1))

    @jax.jit
    def train_step(ps, opt_state, x):
        loss, grads = jax.value_and_grad(loss_fn)(ps, x)
        updates, opt_state = opt.update(grads, opt_state, ps)
        return optax.apply_updates(ps, updates), opt_state, loss

    t0 = time.time()
    ps, opt_state, loss = jax.block_until_ready(train_step(ps, opt_state, x))
    print(f"first step (compile): {time.time() - t0:.1f}s  loss={float(loss):.4f}")
    t0 = time.time()
    for _ in range(steps):
        ps, opt_state, loss = train_step(ps, opt_state, x)
    jax.block_until_ready(loss)
    dt = (time.time() - t0) / steps
    print(f"steady step: {dt * 1e3:.1f} ms  "
          f"({g.num_edges / dt / 1e6:.1f}M edges/s aggregate)")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--cpu8", action="store_true",
                   help="force 8 virtual CPU devices")
    p.add_argument("--nodes", type=int, default=20000)
    p.add_argument("--degree", type=int, default=12)
    args = p.parse_args()
    if args.cpu8:
        import os
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   " --xla_force_host_platform_device_count=8")
        jax.config.update("jax_platforms", "cpu")
    from neuralgraphpde.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main(args.nodes, args.degree)
