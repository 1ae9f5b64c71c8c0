"""Structural graph transforms: self-loops, degree, CSR, receiver-sort.

Equivalents of the reference's reexported GraphNeuralNetworks.jl utilities
consumed at reference src/layers.jl:211 (``add_self_loops``) and :224
(``degree``), plus CSR metadata (no reference equivalent — the
reference's scatter kernels are NNlibCUDA's).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .gnngraph import GnnGraph


def add_self_loops(g: GnnGraph) -> GnnGraph:
    """Append one ``i -> i`` edge per node (reference src/layers.jl:211).

    New edges go at the end, matching the reference's COO behavior (its
    edge-weight padding appends ones at the end, src/layers.jl:215). Edge
    features are dropped, as in GraphNeuralNetworks.jl's ``add_self_loops``.
    """
    n = g.num_nodes
    loop = jnp.arange(n, dtype=jnp.int32)
    senders = jnp.concatenate([g.senders, loop])
    receivers = jnp.concatenate([g.receivers, loop])
    host_coo = None
    if g.host_coo is not None:
        loop_np = np.arange(n, dtype=np.int32)
        host_coo = (np.concatenate([g.host_coo[0], loop_np]),
                    np.concatenate([g.host_coo[1], loop_np]))
    return GnnGraph(
        senders=senders,
        receivers=receivers,
        ndata=g.ndata,
        edata={},
        gdata=g.gdata,
        graph_indicator=g.graph_indicator,
        num_nodes=n,
        num_edges=g.num_edges + n,
        num_graphs=g.num_graphs,
        receivers_sorted=False,
        host_coo=host_coo,
    )


def degree(
    g: GnnGraph,
    dtype=jnp.float32,
    *,
    direction: str = "in",
    edge_weight: Optional[jax.Array] = None,
) -> jax.Array:
    """(Weighted) degree vector, shape ``(num_nodes,)``.

    ``direction='in'`` counts edges by receiver (the reference's
    ``degree(g, T; dir=:in, edge_weight)``, src/layers.jl:224). If
    ``edge_weight`` is given the degree is the sum of incident weights.
    """
    idx = g.receivers if direction == "in" else g.senders
    if edge_weight is None:
        weights = jnp.ones((g.num_edges,), dtype=dtype)
    else:
        weights = edge_weight.astype(dtype)
    return jax.ops.segment_sum(
        weights, idx, num_segments=g.num_nodes,
        indices_are_sorted=g.receivers_sorted and direction == "in",
    )


def sort_by_receiver(g: GnnGraph, return_perm: bool = False):
    """Canonicalize edge order to non-decreasing receiver (CSR-ready).

    Edge features are permuted consistently. Segment reductions over sorted
    receivers let XLA use the fast sorted path. With
    ``return_perm=True`` also returns the applied permutation (new edge slot
    ``k`` holds old edge ``perm[k]``; identity when already sorted).
    """
    if g.receivers_sorted:
        return (g, np.arange(g.num_edges)) if return_perm else g
    if g.num_edges == 0:
        import dataclasses

        g2 = dataclasses.replace(g, receivers_sorted=True)
        return (g2, np.arange(0)) if return_perm else g2
    host_coo = None
    if g.host_coo is not None:
        # permute on host to keep the no-device-read preprocessing path
        s_np, r_np = g.host_coo
        perm_np = np.argsort(r_np, kind="stable")
        host_coo = (s_np[perm_np], r_np[perm_np])
        senders = jnp.asarray(host_coo[0])
        receivers = jnp.asarray(host_coo[1])
        perm = jnp.asarray(perm_np)
    else:
        perm = jnp.argsort(g.receivers, stable=True)
        senders = g.senders[perm]
        receivers = g.receivers[perm]
    g2 = GnnGraph(
        senders=senders,
        receivers=receivers,
        ndata=g.ndata,
        edata={k: v[perm] for k, v in g.edata.items()},
        gdata=g.gdata,
        graph_indicator=g.graph_indicator,
        num_nodes=g.num_nodes,
        num_edges=g.num_edges,
        num_graphs=g.num_graphs,
        receivers_sorted=True,
        host_coo=host_coo,
    )
    return (g2, np.asarray(perm)) if return_perm else g2


def csr_offsets(g: GnnGraph) -> jax.Array:
    """Row offsets (num_nodes + 1,) for a receiver-sorted graph.

    ``offsets[i]:offsets[i+1]`` is the contiguous edge range whose receiver is
    node ``i``. Requires ``g.receivers_sorted``.
    """
    if not g.receivers_sorted:
        raise ValueError("csr_offsets requires a receiver-sorted graph; "
                         "call sort_by_receiver(g) first")
    counts = jax.ops.segment_sum(
        jnp.ones((g.num_edges,), jnp.int32), g.receivers,
        num_segments=g.num_nodes, indices_are_sorted=True,
    )
    return jnp.concatenate([jnp.zeros((1,), jnp.int32),
                            jnp.cumsum(counts).astype(jnp.int32)])


def to_dense_adjacency(
    g: GnnGraph,
    *,
    edge_weight: Optional[jax.Array] = None,
    dtype=jnp.float32,
) -> jax.Array:
    """Dense adjacency ``A[r, s] = sum of weights of edges s -> r``.

    ``A @ X`` then equals receiver-aggregated sum of sender features — the
    dense SpMM path for small graphs (cf. PAPERS.md "Fast Training of Sparse
    GNNs on Dense Hardware").
    """
    n = g.num_nodes
    w = (jnp.ones((g.num_edges,), dtype) if edge_weight is None
         else edge_weight.astype(dtype))
    flat = g.receivers.astype(jnp.int32) * n + g.senders.astype(jnp.int32)
    dense = jax.ops.segment_sum(w, flat, num_segments=n * n)
    return dense.reshape(n, n)


def pad_graph(g: GnnGraph, max_nodes: int, max_edges: int) -> GnnGraph:
    """Pad structure to static ``(max_nodes, max_edges)`` capacities.

    Per-batch graph swapping (``update_graph``, reference VMH.md:134) under
    ``jit`` retraces whenever array shapes change; padding every graph of a
    dataset to one bucket keeps shapes static so the compiled step is reused
    (SURVEY §7 "hard parts"). Padding edges connect padding nodes only, so
    real-node aggregations are untouched; padded feature rows are zero.
    Slice outputs back with ``[:g_true_num_nodes]`` (or mask) downstream.
    """
    if max_nodes < g.num_nodes or max_edges < g.num_edges:
        raise ValueError(
            f"graph ({g.num_nodes} nodes, {g.num_edges} edges) exceeds pad "
            f"bucket ({max_nodes}, {max_edges})")
    if max_nodes == g.num_nodes and max_edges == g.num_edges:
        return g
    if max_nodes == g.num_nodes and max_edges > g.num_edges:
        raise ValueError("edge padding requires at least one padding node")
    pad_e = max_edges - g.num_edges
    pad_n = max_nodes - g.num_nodes
    pad_target = jnp.full((pad_e,), g.num_nodes, jnp.int32)  # first pad node
    senders = jnp.concatenate([g.senders, pad_target])
    receivers = jnp.concatenate([g.receivers, pad_target])
    host_coo = None
    if g.host_coo is not None:
        pt = np.full((pad_e,), g.num_nodes, np.int32)
        host_coo = (np.concatenate([g.host_coo[0], pt]),
                    np.concatenate([g.host_coo[1], pt]))

    def pad_rows(arr, count):
        return jnp.concatenate(
            [arr, jnp.zeros((count,) + arr.shape[1:], arr.dtype)], axis=0)

    gi = g.graph_indicator
    if gi is not None:
        gi = jnp.concatenate([gi, jnp.zeros((pad_n,), jnp.int32)])
    return GnnGraph(
        senders=senders,
        receivers=receivers,
        ndata={k: pad_rows(v, pad_n) for k, v in g.ndata.items()},
        edata={k: pad_rows(v, pad_e) for k, v in g.edata.items()},
        gdata=g.gdata,
        graph_indicator=gi,
        num_nodes=max_nodes,
        num_edges=max_edges,
        num_graphs=g.num_graphs,
        receivers_sorted=g.receivers_sorted,  # pad receivers are max id
        host_coo=host_coo,
    )


def edges_numpy(g: GnnGraph) -> Tuple[np.ndarray, np.ndarray]:
    if g.host_coo is not None:
        return g.host_coo
    return np.asarray(g.senders), np.asarray(g.receivers)


def from_dense_adjacency(adj: np.ndarray, **features) -> GnnGraph:
    """COO graph from a dense adjacency matrix ``adj[r, s] != 0`` ⇒ edge
    ``s -> r``; nonzero values become edge weights in ``edata['e']``.

    The functional stand-in for the reference's ADJMAT-backed ``GNNGraph``
    variant (reference src/layers.jl:204 checks ``GNNGraph{<:ADJMAT_T}``).
    """
    adj = np.asarray(adj)
    r, s = np.nonzero(adj)
    w = adj[r, s].astype(np.float32)
    edata = dict(features.pop("edata", {}) or {})
    if not np.all(w == 1.0):
        edata["e"] = w.reshape(-1, 1)
    return GnnGraph.from_coo(
        s.astype(np.int32), r.astype(np.int32), num_nodes=adj.shape[0],
        edata=edata or None, **features)
