"""Weak-scaling harness (north star: ≥80% efficiency on a ≥10M-edge mesh).

Grows the graph proportionally with the device count and reports aggregate
edges/s and efficiency vs the single-device run. On CPU (--cpu8) the absolute
numbers are meaningless but the harness is identical to what runs on a pod
slice (one process per host via parallel.multihost.initialize()).

python examples/weak_scaling.py --cpu8 --base-nodes 2000 --degree 8
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np


def measure(ndev: int, base_nodes: int, degree: int, feat: int = 64,
            iters: int = 10, mesh_graph: bool = False) -> float:
    import numpy as _np

    from neuralgraphpde import add_self_loops
    from neuralgraphpde.data import random_spmm_graph
    from neuralgraphpde.graph.builders import grid_graph_2d
    from neuralgraphpde.parallel import (
        make_mesh, pad_node_features, partition_graph, shard_node_features,
        sharded_spmm,
    )

    mesh = make_mesh(ndev)
    n = base_nodes * ndev
    if mesh_graph:
        # PDE mesh: grow the grid along x; contiguous receiver blocks are
        # then horizontal strips, so the halo is the strip boundary only
        # (the realistic spatially-partitioned regime, >99% interior edges)
        ny = max(int(_np.sqrt(base_nodes)), 1)
        nx = max(n // ny, 1)
        g = grid_graph_2d(nx, ny, diagonals=True)
        x_np = _np.random.default_rng(0).normal(
            size=(g.num_nodes, feat)).astype(_np.float32)
    else:
        g, x_np = random_spmm_graph(n, degree, feat, seed=0)
    g = add_self_loops(g)
    pg = partition_graph(g, ndev, halo=True)
    if mesh_graph:
        frac = 1.0 - float(jnp.sum(pg.mask_bnd)) / max(g.num_edges, 1)
        print(f"  [{ndev} dev] nodes={g.num_nodes} edges={g.num_edges} "
              f"interior={frac:.2%} halo={pg.halo_size}")
    x = shard_node_features(pad_node_features(x_np, pg), pg, mesh)

    @jax.jit
    def loop(x):
        def body(i, v):
            return jnp.tanh(sharded_spmm(pg, v, mesh))
        return jax.lax.fori_loop(0, iters, body, x)

    jax.block_until_ready(loop(x))  # compile
    t0 = time.perf_counter()
    jax.block_until_ready(loop(x))
    dt = (time.perf_counter() - t0) / iters
    return g.num_edges / dt


def main(device_counts, base_nodes, degree, mesh_graph=False):
    results = {}
    for nd in device_counts:
        if nd > jax.device_count():
            print(f"skipping {nd} devices (only {jax.device_count()})")
            continue
        eps = measure(nd, base_nodes, degree, mesh_graph=mesh_graph)
        results[nd] = eps
        base = results[min(results)]
        eff = eps / (base * nd / min(results))
        print(f"{nd} devices | {eps / 1e6:8.2f} M edges/s aggregate | "
              f"weak-scaling efficiency {eff:.2%}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--cpu8", action="store_true")
    p.add_argument("--base-nodes", type=int, default=2000)
    p.add_argument("--degree", type=int, default=8)
    p.add_argument("--devices", type=int, nargs="*", default=[1, 2, 4, 8])
    p.add_argument("--mesh", action="store_true",
                   help="grid PDE mesh grown along x (strip partitions)")
    args = p.parse_args()
    if args.cpu8:
        _os.environ["XLA_FLAGS"] = (_os.environ.get("XLA_FLAGS", "") +
                                    " --xla_force_host_platform_device_count=8")
        jax.config.update("jax_platforms", "cpu")
    from neuralgraphpde.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main(args.devices, args.base_nodes, args.degree, mesh_graph=args.mesh)
