"""SpMM dispatch: receiver-aggregated sum of sender features.

Computes ``out[i] = Σ_{edges j->i} w_e · x[j]`` — the fixed-message sum
aggregation behind the reference's ``propagate(copy_xj/e_mul_xj/w_mul_xj, g, +)``
(GCNConv hot path, reference src/layers.jl:227-233). Implementations:

- ``xla``   — gather + sorted segment sum; always available.
- ``dense`` — precomputed dense adjacency ``A @ X``, for small graphs.
- ``dia``   — XLA stencil over scalar diagonals (``ops.dia``), for grids
              and other stencil meshes, plus a COO remainder for the few
              edges off the kept diagonals (periodic wrap edges).

``precompute(g, ...)`` attaches the structure these paths need to
``g.cache`` once per graph, so nothing is rebuilt inside the ODE solver
loop. Which path runs is decided in ``spmm`` from the cached structure and
the mode (``set_spmm_mode``), the same way on every platform: hand-written
kernels for these paths were measured against XLA on an H200 and lost
(PERF.md), so every path is plain XLA.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.gnngraph import GnnGraph
from ..graph.transforms import csr_offsets, sort_by_receiver, to_dense_adjacency
__all__ = ["precompute", "spmm", "spmm_xla", "spmm_dense", "spmm_dia",
           "set_spmm_mode", "get_spmm_mode"]

# ``"auto"``: dense adjacency when cached, else the DIA stencil when cached,
# else gather + segment sum. ``"xla"``: gather + segment sum only — the
# reference the other paths are compared with. ``"dense"``: like auto, for
# callers that want to name the dense product.
MODES = ("auto", "xla", "dense")
_SPMM_MODE = "auto"


def set_spmm_mode(mode: str) -> None:
    global _SPMM_MODE
    if mode not in MODES:
        raise ValueError(f"unknown spmm mode {mode!r}; expected one of "
                         f"{MODES}")
    _SPMM_MODE = mode


def get_spmm_mode() -> str:
    return _SPMM_MODE

# Largest stencil bandwidth the full-DIA path accepts; wider diagonals go to
# the DIA-plus-remainder split or stay on the gather path.
DIA_MAX_BANDWIDTH = 8192

# The auto-reorder gate counts the block diagonals of ``REORDER_BLOCK``-row
# blocks an ordering touches: an RCM'd planar mesh of ~10^5 nodes needs ~17;
# a uniform random graph needs all of them.
REORDER_BLOCK = 256
AUTO_REORDER_MAX_BANDS = 24


def _block_bandable(s, r, n, tb, max_bands: int = 16) -> bool:
    """Few distinct ``tb×tb`` block diagonals, and few relative to a dense
    matrix: the ordering keeps every edge near the diagonal."""
    nb = -(-n // tb)
    offs = np.unique(s.astype(np.int64) // tb - r.astype(np.int64) // tb)
    return (len(offs) <= max_bands
            and len(offs) < max((2 * nb - 1) // 2, 2))


def _dia_ok(s, r, n) -> bool:
    from .dia import plan_dia

    plan = plan_dia(s, r, n)
    return plan is not None and (
        (plan.full_ok and plan.full_bw <= DIA_MAX_BANDWIDTH)
        or plan.hybrid_ok)


def _try_auto_reorder(g: GnnGraph):
    """RCM-renumber ``g`` when (and only when) the graph is not
    near-diagonal as labeled but becomes so after RCM. Returns ``(graph,
    order, edge_perm)`` with ``order=None`` when no reorder was applied;
    ``edge_perm`` is the receiver re-sort's edge permutation (new edge slot
    ``k`` holds old edge ``edge_perm[k]``) so per-edge arrays supplied in
    the ORIGINAL edge order can be realigned."""
    from ..graph.reorder import rcm_order, reorder_graph

    if g.host_coo is not None:
        s, r = g.host_coo
    else:
        s, r = np.asarray(g.senders), np.asarray(g.receivers)
    n, tb = g.num_nodes, REORDER_BLOCK
    if n < 4 * tb or g.num_edges == 0:
        return g, None, None
    if _block_bandable(s, r, n, tb) or _dia_ok(s, r, n):
        return g, None, None  # already structured — nothing to unlock
    order = rcm_order(s, r, n)
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n, dtype=np.int64)
    s2, r2 = inv[s.astype(np.int64)], inv[r.astype(np.int64)]
    if not (_block_bandable(s2, r2, n, tb, max_bands=AUTO_REORDER_MAX_BANDS)
            or _dia_ok(s2, r2, n)):
        return g, None, None  # expander-like: no narrow ordering exists
    g2, eperm = reorder_graph(g, order, return_edge_perm=True)
    return g2, order, eperm


def _attach_dia(g: GnnGraph, cache: dict, edge_weight) -> None:
    """Scalar-diagonal storage when the graph is a stencil: full DIA, or the
    kept diagonals plus a COO remainder (periodic grids), whichever the one
    offsets pass (``plan_dia``) accepts. Unstructured graphs get nothing."""
    from .dia import build_dia, build_dia_hybrid, plan_dia

    if g.host_coo is not None:
        s, r = g.host_coo
    else:
        s, r = np.asarray(g.senders), np.asarray(g.receivers)
    plan = plan_dia(s, r, g.num_nodes)
    if plan is None:
        return
    ew = None if edge_weight is None else np.asarray(edge_weight)
    if plan.hybrid_ok and (not plan.full_ok
                           or plan.full_bw > DIA_MAX_BANDWIDTH
                           or 4 * plan.hybrid_bw <= plan.full_bw):
        hyb = build_dia_hybrid(s, r, g.num_nodes, edge_weight=ew)
        if hyb is not None:
            dm, rs, rr, rw = hyb
            cache["dia"] = dm
            cache["dia_rem"] = (jnp.asarray(rs), jnp.asarray(rr),
                                jnp.asarray(rw))
            return
    if plan.full_ok and plan.full_bw <= DIA_MAX_BANDWIDTH:
        dm = build_dia(s, r, g.num_nodes, edge_weight=ew)
        if dm is not None:
            cache["dia"] = dm


def precompute(
    g: GnnGraph,
    *,
    dense: Optional[bool] = None,
    csr: bool = True,
    dense_threshold_nodes: int = 8192,
    adj_dtype=jnp.float32,
    edge_weight=None,
    add_self_loops: bool = False,
    dia: Optional[bool] = None,
    auto_reorder: bool = False,
) -> GnnGraph:
    """Attach SpMM acceleration structure to ``g.cache``.

    - ``in_degree``: receiver degrees (weighted by ``edge_weight``).
    - ``adj`` (``dense``; default: ``num_nodes <= dense_threshold_nodes``):
      dense unweighted adjacency, receiver-major.
    - ``csr_offsets`` (``csr``): row offsets, after sorting edges by
      receiver — the sorted order is what every segment sum relies on.
    - ``dia`` / ``dia_rem`` (``dia``; default: not dense): the stencil
      storage when the graph is diagonal-structured.

    ``auto_reorder=True``: when the graph is NOT near-diagonal as labeled
    but an RCM renumbering makes it so (spatially local meshes fed with
    scrambled labels — Delaunay/radius graphs), the nodes are relabeled
    first, which keeps the gathers of the segment sum local. The
    permutation is recorded in ``cache['node_order']`` (old id of each new
    node) — THE NODE IDS CHANGE: permute per-node features with
    ``graph.reorder.permute_nodes(x, order)`` and map outputs back with
    ``unpermute_nodes``. Graphs that stay unstructured after RCM (e.g.
    uniform random — expanders have no narrow ordering) are left unchanged.

    ``add_self_loops=True`` adds self-loops *before* building the structure
    and marks the cache, so ``GCNConv`` (whose default is
    ``add_self_loops=True``, reference src/layers.jl:211) recognises the
    graph as already self-looped and keeps the fast path instead of
    rebuilding the graph per forward.

    Must be called outside jit (host-side build).
    """
    orig_edges = g.num_edges
    if add_self_loops:
        from ..graph.transforms import add_self_loops as _asl

        g = _asl(g)
    node_order = None
    edge_perm = None
    if auto_reorder:
        g, node_order, edge_perm = _try_auto_reorder(g)
        if edge_perm is not None and edge_weight is not None:
            # the reorder re-sorted edges by the new receiver labels —
            # realign caller-supplied weights (they arrive in the
            # ORIGINAL edge order) before anything consumes them
            edge_weight = jnp.take(jnp.asarray(edge_weight),
                                   jnp.asarray(edge_perm, jnp.int32),
                                   axis=0)
    if dense is None:
        dense = g.num_nodes <= dense_threshold_nodes
    if dia is None:
        dia = not dense
    perm = None
    if csr and not g.receivers_sorted:
        g, perm = sort_by_receiver(g, return_perm=True)
    cache = dict(g.cache)
    if node_order is not None:
        cache["node_order"] = jnp.asarray(node_order, jnp.int32)
    if add_self_loops:
        cache["self_looped"] = True
        # where each *original* edge landed in the current (looped,
        # reordered, sorted) edge order — lets runtime edge weights given
        # for the original edges be scattered into place (loops get unit
        # weight). Compose the auto_reorder edge permutation with the
        # later receiver sort (slot k of the final order holds old edge
        # edge_perm[perm[k]]).
        comb = edge_perm
        if perm is not None:
            comb = (np.asarray(perm) if comb is None
                    else np.asarray(comb)[np.asarray(perm)])
        if comb is None:
            pos = np.arange(orig_edges)
        else:
            comb = np.asarray(comb)
            inv = np.empty(len(comb), np.int64)
            inv[comb] = np.arange(len(comb))
            pos = inv[:orig_edges]
        cache["orig_edge_pos"] = jnp.asarray(pos, jnp.int32)
    from ..graph.transforms import degree as _degree

    cache["in_degree"] = _degree(g, jnp.float32, direction="in",
                                 edge_weight=edge_weight)
    if dense:
        cache["adj"] = to_dense_adjacency(g, dtype=adj_dtype)
    if csr:
        cache["csr_offsets"] = csr_offsets(g)
    if dia and g.num_edges:
        _attach_dia(g, cache, edge_weight)
    return g.copy(cache=cache)


def spmm_xla(g: GnnGraph, x: jax.Array,
             edge_weight: Optional[jax.Array] = None) -> jax.Array:
    xj = jnp.take(x, g.senders, axis=0)
    if edge_weight is not None:
        xj = xj * edge_weight.reshape((-1,) + (1,) * (x.ndim - 1))
    return jax.ops.segment_sum(
        xj, g.receivers, num_segments=g.num_nodes,
        indices_are_sorted=g.receivers_sorted,
    )


def spmm_dense(g: GnnGraph, x: jax.Array) -> jax.Array:
    adj = g.cache["adj"]
    return jnp.dot(adj, x.astype(adj.dtype),
                   preferred_element_type=x.dtype).astype(x.dtype)


def spmm_dia(g: GnnGraph, x: jax.Array) -> jax.Array:
    from .dia import dia_remainder_spmm, dia_spmm

    y = dia_spmm(g.cache["dia"], x)
    rem = g.cache.get("dia_rem")
    if rem is not None:  # hybrid: + tiny COO remainder (wrap edges)
        y = y + dia_remainder_spmm(rem, x, g.num_nodes)
    return y


def spmm(g: GnnGraph, x: jax.Array,
         edge_weight: Optional[jax.Array] = None) -> jax.Array:
    """Receiver-sum of (optionally weighted) sender features, dispatching per
    ``set_spmm_mode`` and the structure cached on ``g``. Runtime edge
    weights cannot ride a precomputed structure, so they take the XLA
    path."""
    if _SPMM_MODE == "xla" or edge_weight is not None:
        return spmm_xla(g, x, edge_weight)
    if g.cache.get("adj") is not None:
        return spmm_dense(g, x)
    if (_SPMM_MODE == "auto" and g.cache.get("dia") is not None
            and x.ndim == 2):
        return spmm_dia(g, x)
    return spmm_xla(g, x)
