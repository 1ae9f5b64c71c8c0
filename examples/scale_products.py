"""Config 5 scale demonstration (BASELINE.json configs[4]): GRAND diffusion
at ogbn-products scale — ~2.45M nodes / ~124M directed edges — edge-
partitioned with halo exchange.

The graph is a synthetic stand-in with the ogbn-products shape (no network
egress in this environment; the real loader is
``neuralgraphpde.data.loaders.ogb_node_dataset(path=...)``).

Stages (all reported with wall time + peak RSS):
  build     generate COO, receiver-sort, degree        (host, NumPy/C++)
  partition partition_graph(P) for the distributed path
  step8     one distributed GRAND train step on an 8-device virtual CPU mesh

python examples/scale_products.py --stage build,partition
XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python examples/scale_products.py --cpu --stage step8 --feat 8
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import argparse
import resource
import time

import numpy as np

NUM_NODES = 2_449_029  # ogbn-products
NUM_EDGES = 123_718_280  # directed (2x undirected)


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def log(stage, t0, **kw):
    extras = " ".join(f"{k}={v}" for k, v in kw.items())
    print(f"[{stage:9s}] {time.perf_counter() - t0:8.1f}s  "
          f"rss={rss_gb():5.1f}GB  {extras}", flush=True)


def build_graph(nodes, edges, seed=0):
    """Synthetic products-shape COO: power-lawish senders (hubs), uniform
    receivers — degree skew comparable to a co-purchase graph."""
    rng = np.random.default_rng(seed)
    # hub-biased senders: mix of uniform and a heavy head
    n_hub = max(nodes // 100, 1)
    hub_edges = edges // 4
    s = np.empty(edges, np.int32)
    s[:hub_edges] = rng.integers(0, n_hub, hub_edges, dtype=np.int32)
    s[hub_edges:] = rng.integers(0, nodes, edges - hub_edges, dtype=np.int32)
    r = rng.integers(0, nodes, edges, dtype=np.int32)
    return s, r


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--nodes", type=int, default=NUM_NODES)
    p.add_argument("--edges", type=int, default=NUM_EDGES)
    p.add_argument("--stage", default="build,partition")
    p.add_argument("--feat", type=int, default=16)
    p.add_argument("--parts", type=int, default=8)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args()
    stages = set(args.stage.split(","))

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from neuralgraphpde.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    t0 = time.perf_counter()
    s, r = build_graph(args.nodes, args.edges)
    log("generate", t0, edges=args.edges, nodes=args.nodes)

    if "partition" in stages:
        from neuralgraphpde import GnnGraph
        from neuralgraphpde.parallel import partition_graph

        t0 = time.perf_counter()
        g = GnnGraph.from_coo(s, r, num_nodes=args.nodes)
        log("graph", t0)
        t0 = time.perf_counter()
        pg = partition_graph(g, args.parts, halo=True)
        log("partition", t0, parts=args.parts, halo=int(pg.halo_size),
            epp=int(pg.senders_global.shape[1]))
        del g, pg

    if "step8" in stages:
        import jax.numpy as jnp
        import optax

        from neuralgraphpde import GnnGraph, setup
        from neuralgraphpde.parallel import (
            make_mesh, pad_node_features, partition_graph,
            shard_node_features, sharded_grand_model)

        ndev = 8
        if jax.device_count() < ndev:
            raise SystemExit("need XLA_FLAGS=--xla_force_host_platform_"
                             "device_count=8 (and --cpu)")
        mesh = make_mesh(ndev)
        g = GnnGraph.from_coo(s, r, num_nodes=args.nodes)
        t0 = time.perf_counter()
        pg = partition_graph(g, ndev, halo=True)
        log("partition", t0, parts=ndev)

        f = args.feat
        model = sharded_grand_model(f, f, 4, mesh, initialgraph=lambda: pg,
                                    solver="euler", steps_per_interval=2)
        ps, st = setup(jax.random.PRNGKey(0), model)
        rng = np.random.default_rng(0)
        x = shard_node_features(
            pad_node_features(
                rng.normal(size=(g.num_nodes, f)).astype(np.float32), pg),
            pg, mesh)
        labels = jnp.asarray(rng.integers(0, 4, size=g.num_nodes))

        opt = optax.adam(1e-2)
        opt_state = opt.init(ps)

        def loss_fn(ps, x):
            logits, _ = model(x, ps, st)
            logp = jax.nn.log_softmax(logits[: g.num_nodes], axis=-1)
            return -jnp.mean(
                jnp.take_along_axis(logp, labels[:, None], axis=-1))

        @jax.jit
        def train_step(ps, opt_state, x):
            loss, grads = jax.value_and_grad(loss_fn)(ps, x)
            updates, opt_state = opt.update(grads, opt_state, ps)
            return optax.apply_updates(ps, updates), opt_state, loss

        t0 = time.perf_counter()
        ps, opt_state, loss = train_step(ps, opt_state, x)
        jax.block_until_ready(loss)
        log("step8", t0, loss=float(loss))
        assert np.isfinite(float(loss))


if __name__ == "__main__":
    main()
