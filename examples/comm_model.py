"""Communication-volume model for multi-card weak scaling.

Projects weak-scaling efficiency from quantities the partitioner measures.
Per RHS evaluation on an edge-partitioned graph (parallel/halo.py
`_local_spmm_block_overlap`):

- link traffic per device = n_blocks · H · F · itemsize (the all_to_all
  ships one padded (H, F) halo block to each of P-1 peers; the neighbour
  ``ppermute`` exchange of strip meshes ships 2; H = `partition_graph`'s
  measured max boundary-row count over peer pairs, padded to 8),
- local HBM traffic per device:
    DIA strip-mesh path ≈ 2 · npp·F·b + npp·K·b (one x read — the shifted
      rows come from L2 — one output write, the value sheet), plus the same
      again for the transpose pass in a gradient step;
    gather path on a random graph ≈ (E/P)·F·b + 2 · npp·F·b.

With the interior/boundary split the halo exchange overlaps the interior
segment sum, so projected efficiency = t_hbm / max(t_hbm, t_link) — the
exchange only costs wall-clock once it exceeds the local work it hides
under. This is arithmetic from shapes; no multi-card time has been measured
yet.

Bandwidths are CLI flags; the defaults are an H200's published figures
(NVIDIA data sheet): HBM 4,800 GB/s, and NVLink 900 GB/s per card to the
other cards of the host, which is 450 GB/s each way.

Run:  python examples/comm_model.py            # 10M-edge strip mesh
      python examples/comm_model.py --random   # + uniform random graph
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import argparse

import jax

# pure host arithmetic: the partitioner runs on the CPU
jax.config.update("jax_platforms", "cpu")

import numpy as np


def model(kind: str, n_target: int, feat: int, itemsize: int,
          hbm_gbps: float, link_gbps: float, parts=(4, 8, 16)):
    from neuralgraphpde import add_self_loops
    from neuralgraphpde.graph.builders import grid_graph_2d, rand_graph
    from neuralgraphpde.parallel import partition_graph

    if kind == "mesh":
        ny = 1024
        nx = max(n_target // ny, 1)
        g = add_self_loops(grid_graph_2d(nx, ny, diagonals=True))
    else:
        g = add_self_loops(rand_graph(n_target, 8 * n_target, seed=0))
    N, E = g.num_nodes, g.num_edges
    print(f"[{kind}] nodes={N:,} edges={E:,} F={feat} "
          f"itemsize={itemsize}")
    print(f"{'P':>3} {'npp':>9} {'H':>7} {'nbr':>4} {'halo%':>7} "
          f"{'link MB/dev':>11} "
          f"{'HBM MB/dev':>10} {'t_link us':>9} {'t_hbm us':>9} "
          f"{'proj eff':>8}")
    rows = []
    for P in parts:
        pg = partition_graph(g, P, halo=True)
        H = pg.halo_size
        npp = pg.nodes_per_part
        # measured wire volume: the neighbor-ppermute exchange (engaged
        # automatically when partition_graph detects adjacent-only halos —
        # strip meshes) ships 2 padded H·F blocks per device regardless of
        # P; the dense all_to_all ships (P-1)
        n_blocks = 2 if pg.halo_neighbor_only else (P - 1)
        link_bytes = n_blocks * H * feat * itemsize
        if kind == "mesh":
            # XLA stencil local pass: x read, output write, value sheet
            # (9 offsets on the self-looped 8-neighbourhood grid)
            K = 9
            hbm_bytes = 2 * npp * feat * itemsize + npp * K * itemsize
        else:
            # gather + segment sum: edge gather + x read + output write
            hbm_bytes = (E / P) * feat * itemsize + 2 * npp * feat * itemsize
        t_link = link_bytes / (link_gbps * 1e9)
        t_hbm = hbm_bytes / (hbm_gbps * 1e9)
        eff = t_hbm / max(t_hbm, t_link)
        rows.append((P, npp, H, link_bytes, hbm_bytes, eff))
        print(f"{P:>3} {npp:>9,} {H:>7,} {'y' if pg.halo_neighbor_only else 'n':>4} "
              f"{100.0 * H * n_blocks / npp:>6.2f}% "
              f"{link_bytes / 1e6:>11.3f} {hbm_bytes / 1e6:>10.2f} "
              f"{t_link * 1e6:>9.2f} {t_hbm * 1e6:>9.2f} {eff:>8.1%}")
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=1_179_648,
                    help="target node count (default 1152x1024 grid -> "
                         "~10.6M edges with diagonals+loops)")
    ap.add_argument("--feat", type=int, default=128)
    ap.add_argument("--bf16", action="store_true", default=True)
    ap.add_argument("--f32", dest="bf16", action="store_false")
    ap.add_argument("--hbm-gbps", type=float, default=4800.0,
                    help="per-card HBM bandwidth (H200)")
    ap.add_argument("--link-gbps", type=float, default=450.0,
                    help="per-card NVLink bandwidth, one direction (H200)")
    ap.add_argument("--random", action="store_true",
                    help="also model the uniform random graph")
    args = ap.parse_args()
    itemsize = 2 if args.bf16 else 4
    model("mesh", args.nodes, args.feat, itemsize, args.hbm_gbps,
          args.link_gbps)
    if args.random:
        model("random", args.nodes // 8, args.feat, itemsize,
              args.hbm_gbps, args.link_gbps)


if __name__ == "__main__":
    main()
