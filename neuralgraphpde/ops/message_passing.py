"""Message-passing engine: ``propagate`` / ``apply_edges`` / ``aggregate_neighbors``.

The rebuild of the GraphNeuralNetworks.jl primitives the reference
consumes (reference src/NeuralGraphPDE.jl:9-11; semantics documented in SURVEY
§1 L1): for every edge ``j -> i`` (sender j, receiver i) gather ``xj`` at the
sender, ``xi`` at the receiver and ``e`` at the edge, apply the message
function over all edges at once (one big batched computation), then
segment-reduce messages onto receiver nodes.

Feature arguments may be arrays ``(num_nodes, F)`` or dicts of arrays; message
functions receive the edge-expanded version with the same structure.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Union

import jax
import jax.numpy as jnp

from ..graph.gnngraph import GnnGraph
from .scatter import Reduction, canonical_reduction, gather, segment_reduce

Features = Union[jax.Array, Dict[str, jax.Array], None]


# ----------------------------------------------------------- builtin messages
# Equivalents of the reference-reexported builtins (src/NeuralGraphPDE.jl:10-11).
def copy_xj(xi, xj, e):
    return xj


def copy_xi(xi, xj, e):
    return xi


def xi_dot_xj(xi, xj, e):
    return jnp.sum(xi * xj, axis=-1, keepdims=True)


def xi_sub_xj(xi, xj, e):
    return xi - xj


def xj_sub_xi(xi, xj, e):
    return xj - xi


def e_mul_xj(xi, xj, e):
    """Edge-scalar (or edge-vector) weighted sender features."""
    e = e if e.ndim == xj.ndim else e.reshape(e.shape + (1,) * (xj.ndim - e.ndim))
    return e * xj


def w_mul_xj(xi, xj, e):
    """Like ``e_mul_xj`` but reading the graph's stored edge weight; resolved
    by ``propagate`` from ``g.edata['e']``."""
    return e_mul_xj(xi, xj, e)


_BUILTIN_SUM_FASTPATH = (copy_xj, e_mul_xj, w_mul_xj)


def _tree_gather(x: Features, idx: jax.Array) -> Features:
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: gather(v, idx) for k, v in x.items()}
    return gather(x, idx)


def apply_edges(
    message: Callable,
    g: GnnGraph,
    *,
    xi: Features = None,
    xj: Features = None,
    e: Features = None,
) -> Any:
    """Edge-expand node features and evaluate ``message(xi_e, xj_e, e)`` over
    all edges (reference ``apply_edges``)."""
    xi_e = _tree_gather(xi, g.receivers)
    xj_e = _tree_gather(xj, g.senders)
    return message(xi_e, xj_e, e)


def aggregate_neighbors(
    g: GnnGraph,
    aggr: Reduction,
    messages: jax.Array,
) -> jax.Array:
    """Segment-reduce ``(num_edges, F)`` messages onto receiver nodes
    (reference ``aggregate_neighbors``)."""
    return segment_reduce(
        messages, g.receivers, g.num_nodes, aggr,
        indices_are_sorted=g.receivers_sorted,
    )


def propagate(
    message: Callable,
    g: GnnGraph,
    aggr: Reduction,
    *,
    xi: Features = None,
    xj: Features = None,
    e: Features = None,
) -> jax.Array:
    """gather → message → segment-reduce, the reference's ``propagate``
    contract (SURVEY §1; used at reference src/layers.jl:111,228,326,416,534,
    656).

    For the fixed-message sum path (``copy_xj`` / ``e_mul_xj`` / ``w_mul_xj``
    with ``aggr='sum'``) this routes through the SpMM dispatcher
    (:mod:`neuralgraphpde.ops.spmm`), which picks the dense, stencil or
    gather + segment-sum implementation.
    """
    if message is w_mul_xj and e is None:
        if "e" not in g.edata:
            raise ValueError("w_mul_xj requires edge weights in g.edata['e']")
        e = g.edata["e"]

    if (
        message in _BUILTIN_SUM_FASTPATH
        and canonical_reduction(aggr) == "sum"
        and xj is not None
        and not isinstance(xj, dict)
    ):
        xj = jnp.asarray(xj)
        from .spmm import spmm  # local import to avoid cycle

        weight = None
        if message in (e_mul_xj, w_mul_xj):
            weight = e["e"] if isinstance(e, dict) else jnp.asarray(e)
            weight = weight.reshape(-1) if weight.ndim > 1 else weight
        return spmm(g, xj, edge_weight=weight)

    msgs = apply_edges(message, g, xi=xi, xj=xj, e=e)
    return aggregate_neighbors(g, aggr, msgs)


# ------------------------------------------------- per-graph reductions
# Equivalents of the reference-reexported reduce/softmax/broadcast helpers
# (src/NeuralGraphPDE.jl:5-7).
def _graph_ids_nodes(g: GnnGraph) -> jax.Array:
    if g.graph_indicator is not None:
        return g.graph_indicator
    return jnp.zeros((g.num_nodes,), jnp.int32)


def _graph_ids_edges(g: GnnGraph) -> jax.Array:
    return _graph_ids_nodes(g)[g.receivers] if g.num_graphs > 1 else jnp.zeros(
        (g.num_edges,), jnp.int32)


def reduce_nodes(aggr: Reduction, g: GnnGraph, x: jax.Array) -> jax.Array:
    """Reduce node features to per-graph rows ``(num_graphs, F)``."""
    return segment_reduce(x, _graph_ids_nodes(g), g.num_graphs, aggr)


def reduce_edges(aggr: Reduction, g: GnnGraph, e: jax.Array) -> jax.Array:
    return segment_reduce(e, _graph_ids_edges(g), g.num_graphs, aggr)


def broadcast_nodes(g: GnnGraph, x: jax.Array) -> jax.Array:
    """Expand per-graph rows ``(num_graphs, F)`` to ``(num_nodes, F)``."""
    return jnp.take(x, _graph_ids_nodes(g), axis=0)


def broadcast_edges(g: GnnGraph, x: jax.Array) -> jax.Array:
    return jnp.take(x, _graph_ids_edges(g), axis=0)


def _segment_softmax(x, ids, num_segments, indices_are_sorted=False):
    maxes = jax.ops.segment_max(
        jax.lax.stop_gradient(x), ids, num_segments,
        indices_are_sorted=indices_are_sorted)
    maxes = jnp.where(jnp.isfinite(maxes), maxes, 0.0)
    ex = jnp.exp(x - jnp.take(maxes, ids, axis=0))
    denom = jax.ops.segment_sum(ex, ids, num_segments,
                                indices_are_sorted=indices_are_sorted)
    return ex / jnp.take(jnp.maximum(denom, 1e-30), ids, axis=0)


def softmax_nodes(g: GnnGraph, x: jax.Array) -> jax.Array:
    """Per-graph softmax over nodes."""
    return _segment_softmax(x, _graph_ids_nodes(g), g.num_graphs)


def softmax_edges(g: GnnGraph, e: jax.Array) -> jax.Array:
    return _segment_softmax(e, _graph_ids_edges(g), g.num_graphs)


def softmax_edge_neighbors(g: GnnGraph, e: jax.Array) -> jax.Array:
    """Softmax of edge values over each receiver's incident edges (attention
    normalization)."""
    return _segment_softmax(e, g.receivers, g.num_nodes,
                            indices_are_sorted=g.receivers_sorted)
