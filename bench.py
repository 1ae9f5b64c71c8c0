"""Benchmark: the GCN ODE right-hand side and the VMH layer — edges/s on one
GPU.

Primary metric: the GCN ODE RHS (degree-scale → SpMM → degree-scale →
weight matmul → tanh) on a 512x512 8-neighbourhood grid mesh, F=128, run in
an on-device ``fori_loop`` and reported as sustained edges/s. The headline
is the float32 path ``precompute`` selects on that mesh (``dia``);
``vs_baseline`` divides it by the float32 XLA gather + segment-sum RHS on
the same mesh (the structural equivalent of the reference's scatter path).
The bf16 paths are printed beside it and kept out of the headline: a change
of precision is a different result, not a faster one.

Cells (each a worker process, run one at a time; the parent stays off JAX
so one process holds the card at a time):

- ``mesh``: ``xla`` (gather + sorted segment sum) and ``dia`` (the XLA
  stencil ``precompute`` selects on this mesh), each in f32 and bf16.
- ``reord``: 131,072-point Delaunay mesh with scrambled labels: ``xla`` as
  labeled, ``auto`` after ``precompute(auto_reorder=True)``'s RCM relabel.
- ``rand``: 2^18 nodes, degree 16: ``xla`` and the dense-strided gather
  bound (random-row reads + streaming sum, no scatter).
- ``vmh``: VMHConv at the tutorial widths (hidden 60, msg 40) on a 32,768
  point Delaunay mesh: forward (``fwd``) and forward + VJP (``grad``).

Each path is timed REPEATS times (host clock around ``block_until_ready``);
the median is the result and the min-max spread is printed. The first lines
name the platform, device kind, device count, card name and power limit.
Without a GPU the workers fail and no result is printed.

Prints ONE JSON line (last line):
  {"metric": ..., "value": N, "unit": "edges/s", "vs_baseline": R,
   "device": {...}}
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

MESH_NX = MESH_NY = 512
FEAT = 128
ITERS = 50
REPEATS = 5
RAND_NODES = 1 << 18
RAND_DEG = 16
REORD_POINTS = 1 << 17
VMH_POINTS = 1 << 15
VMH_HIDDEN, VMH_MSG = 60, 40
WORKER_TIMEOUT_S = 900
JOBS = [("mesh", ("xla", "dia", "xla_bf16", "dia_bf16")),
        ("reord", ("xla", "auto")),
        ("rand", ("xla", "gather_bound")),
        ("vmh", ("fwd", "grad"))]


def _timed(fn, *args):
    """Median and spread of ``REPEATS`` timed calls (after a warm-up)."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2], ts[0], ts[-1]


def _device_info() -> dict:
    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        raise RuntimeError(f"bench needs a GPU; JAX found {d.platform}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "card": smi[0] if smi else ""}


def _gcn_worker(emit, tag, paths) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from neuralgraphpde import precompute
    from neuralgraphpde.graph.builders import delaunay_graph, grid_graph_2d
    from neuralgraphpde.ops.spmm import spmm

    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.normal(size=(FEAT, FEAT)) / np.sqrt(FEAT),
                    jnp.float32)
    if tag == "mesh":
        g0 = grid_graph_2d(MESH_NX, MESH_NY, diagonals=True)
    elif tag == "reord":
        g0 = delaunay_graph(rng.random((REORD_POINTS, 2)))
    else:
        from neuralgraphpde import rand_graph

        g0 = rand_graph(RAND_NODES, RAND_NODES * RAND_DEG, seed=0)
    plain = precompute(g0, add_self_loops=True, dia=False)
    E, n = plain.num_edges, plain.num_nodes
    emit(f"INFO {tag}: nodes={n} edges={E}")
    c = jnp.where(plain.cache["in_degree"] > 0,
                  1.0 / jnp.sqrt(jnp.maximum(plain.cache["in_degree"], 1.0)),
                  0.0)[:, None]
    x = jnp.asarray(rng.normal(size=(n, FEAT)), jnp.float32)

    def layer_rhs(v, g):
        h = spmm(g, v * c.astype(v.dtype)) * c.astype(v.dtype)
        return jnp.tanh(jnp.dot(h, w.astype(v.dtype)))

    for path in paths:
        try:
            x_run = x.astype(jnp.bfloat16) if path.endswith("bf16") else x
            if path.startswith("xla") or path == "gather_bound":
                g = plain
            else:
                g = precompute(g0, add_self_loops=True,
                               auto_reorder=(tag == "reord"))
            if path == "gather_bound":
                def rhs(v, g):
                    xj = jnp.take(v, g.senders, axis=0)
                    return jnp.sum(xj[: n * RAND_DEG].reshape(
                        n, RAND_DEG, FEAT), axis=1)
            else:
                rhs = layer_rhs

            @jax.jit
            def loop(x0, g, rhs=rhs):
                return jax.lax.fori_loop(0, ITERS, lambda i, v: rhs(v, g),
                                         x0)

            med, lo, hi = _timed(loop, x_run, g)
            emit(f"RESULT {tag} {path} {E * ITERS / med} "
                 f"{E * ITERS / hi} {E * ITERS / lo}")
        except Exception as err:  # keep going: later paths may still work
            emit(f"FAIL {tag} {path} {type(err).__name__}: {str(err)[:200]}")


def _vmh_worker(emit, paths) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from neuralgraphpde import VMHConv, precompute, setup, update_graph
    from neuralgraphpde.graph.builders import delaunay_graph
    from neuralgraphpde.nn.basic import MLP

    rng = np.random.default_rng(0)
    pts = rng.random((VMH_POINTS, 2)).astype(np.float32)
    g = precompute(delaunay_graph(pts, ndata={"x": pts}), dense=False)
    E = g.num_edges
    emit(f"INFO vmh: nodes={g.num_nodes} edges={E} hidden={VMH_HIDDEN} "
         f"msg={VMH_MSG}")
    layer = VMHConv(MLP((4, VMH_HIDDEN, VMH_HIDDEN, VMH_HIDDEN, VMH_MSG),
                        "tanh"),
                    MLP((1 + VMH_MSG, VMH_HIDDEN, VMH_HIDDEN, VMH_HIDDEN, 1),
                        "tanh"))
    ps, st = setup(jax.random.PRNGKey(0), layer)
    st = update_graph(st, g)
    x = jnp.asarray(rng.normal(size=(g.num_nodes, 1)), jnp.float32)
    for path in paths:
        try:
            if path == "grad":
                def rhs(v, st):
                    def f(v):
                        y, _ = layer(v, ps, st)
                        return jnp.sum(y * y)

                    return v - 1e-9 * jax.grad(f)(v)
            else:
                def rhs(v, st):
                    return layer(v, ps, st)[0]

            @jax.jit
            def loop(x0, st, rhs=rhs):
                return jax.lax.fori_loop(0, ITERS, lambda i, v: rhs(v, st),
                                         x0)

            med, lo, hi = _timed(loop, x, st)
            emit(f"RESULT vmh {path} {E * ITERS / med} {E * ITERS / hi} "
                 f"{E * ITERS / lo}")
        except Exception as err:
            emit(f"FAIL vmh {path} {type(err).__name__}: {str(err)[:200]}")


def _worker(outfile: str, tag: str, paths) -> None:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from neuralgraphpde.utils.compile_cache import enable_compile_cache

    def emit(line: str) -> None:
        with open(outfile, "a") as f:
            f.write(line + "\n")

    try:
        info = _device_info()
    except Exception as err:
        emit(f"FAIL {tag} all {type(err).__name__}: {err}")
        return
    enable_compile_cache()
    emit("DEVICE " + json.dumps(info))
    if tag == "vmh":
        _vmh_worker(emit, paths)
    else:
        _gcn_worker(emit, tag, paths)


def main():
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        _worker(sys.argv[i + 1], sys.argv[i + 2], sys.argv[i + 3].split(","))
        return 0

    fd, outfile = tempfile.mkstemp(prefix="ngpde_bench_")
    os.close(fd)
    for tag, paths in JOBS:
        try:
            subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 outfile, tag, ",".join(paths)],
                timeout=WORKER_TIMEOUT_S, capture_output=True)
        except subprocess.TimeoutExpired:
            print(f"# {tag} worker hit timeout", flush=True)

    results = {}
    device = None
    with open(outfile) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "DEVICE":
                device = json.loads(line[len("DEVICE "):])
            elif parts[0] == "RESULT":
                med, lo, hi = map(float, parts[3:6])
                results[(parts[1], parts[2])] = med
                print(f"# {parts[1]}/{parts[2]}: {med / 1e6:.1f} M edges/s "
                      f"(spread {lo / 1e6:.1f}-{hi / 1e6:.1f})", flush=True)
            elif parts[0] in ("FAIL", "INFO"):
                print("# " + line.strip(), flush=True)
    os.unlink(outfile)
    if device is None:
        print("bench: no GPU result", file=sys.stderr)
        return 1
    print(f"# device: {json.dumps(device)}", flush=True)
    head = results.get(("mesh", "dia"), 0.0)
    base = results.get(("mesh", "xla"), 0.0)
    if head <= 0:
        print("bench: no mesh result", file=sys.stderr)
        return 1
    print(json.dumps({
        "metric": "spmm_ode_rhs_edges_per_s_per_chip",
        "value": round(head, 1), "unit": "edges/s",
        "vs_baseline": round(head / base, 4) if base > 0 else None,
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
