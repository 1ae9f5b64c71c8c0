"""Edge partitioning for multi-device graph execution.

The reference is single-device (SURVEY §2.3: no parallelism anywhere in the
Julia package); this module provides the north-star capability from
BASELINE.json: partition the graph's edges (and their incident nodes) across
devices so each right-hand-side evaluation does local gather → message →
segment-reduce with only boundary node features exchanged.

Scheme (v1):
- Nodes are split into ``P`` contiguous blocks of equal size (padded).
- Each edge is owned by the partition of its *receiver*, so segment
  reductions never cross devices; only sender features need communication.
- Per-partition edge lists are padded to the max per-partition count so all
  shapes are static; padded edges are masked.

Built host-side with NumPy: partitioning is data preparation, done once.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..graph.gnngraph import FeatureDict, GnnGraph


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True, eq=False)
class PartitionedGraph:
    """Static edge-partitioned graph. Arrays carry a leading device axis
    ``P`` and are intended to be sharded over a mesh axis with
    ``PartitionSpec('graph', ...)`` (one row per device)."""

    senders_global: jax.Array  # (P, E_max) int32 — global sender ids
    receivers_local: jax.Array  # (P, E_max) int32 — receiver - block_start
    edge_mask: jax.Array  # (P, E_max) float32 — 0 on padding
    in_degree: jax.Array  # (P, nodes_per_part) float32 (true graph degrees)
    node_mask: jax.Array  # (P, nodes_per_part) float32 — 0 on padded nodes
    num_partitions: int
    nodes_per_part: int
    num_nodes: int  # true (unpadded) node count
    num_edges: int  # true edge count
    # --- targeted halo exchange (optional; built by partition_graph when
    # halo=True). For device p:
    #   send_idx[p, q, h]   — local row index p must send to q (0-padded)
    #   senders_halo[p, e]  — sender remapped into p's local+halo table:
    #                         own rows at [0, npp); row from peer q, slot h at
    #                         npp + q*H + h
    halo_size: int = 0  # H (max rows any device sends any peer)
    send_idx: Optional[jax.Array] = None  # (P, P, H) int32
    senders_halo: Optional[jax.Array] = None  # (P, E_max) int32
    # --- interior/boundary split (optional, built with halo): lets the local
    # interior aggregation overlap with the in-flight all_to_all (SURVEY
    # §5.7). Interior edges have a local sender; boundary senders index the
    # *received* halo rows (q*H + h).
    senders_int: Optional[jax.Array] = None  # (P, Ei_max) int32 local ids
    recv_int: Optional[jax.Array] = None  # (P, Ei_max) int32
    mask_int: Optional[jax.Array] = None  # (P, Ei_max, 1) float32
    senders_bnd: Optional[jax.Array] = None  # (P, Eb_max) int32 halo-row ids
    recv_bnd: Optional[jax.Array] = None  # (P, Eb_max) int32
    mask_bnd: Optional[jax.Array] = None  # (P, Eb_max, 1) float32
    # --- per-partition DIA (scalar-diagonal) storage of the INTERIOR edges
    # (strip partitions of regular grids preserve the diagonal offsets). Offsets
    # are a symmetric union across partitions (one static tuple for all).
    dia_values: Optional[jax.Array] = None  # (P, nodes_per_part, K)
    dia_offsets: tuple = ()
    # per-partition edge features (P, E_max, F), permuted like the edges
    edata: FeatureDict = dataclasses.field(default_factory=dict)
    # node features (padded_nodes, F) — shard row-wise like the inputs
    ndata: FeatureDict = dataclasses.field(default_factory=dict)
    # per-graph features (num_graphs, F) — tiny, replicated on every device
    # (the reference's gdata/θ contract, src/layers.jl:397)
    gdata: FeatureDict = dataclasses.field(default_factory=dict)
    num_graphs: int = 1
    # True when every halo row travels between ADJACENT partitions only
    # (strip partitions of spatially ordered meshes): the exchange then
    # rides two neighbor ppermutes — 2·H rows on the wire per device
    # instead of the dense all_to_all's (P-1)·H — so the link traffic of a halo
    # exchange stays FLAT in P (examples/comm_model.py quantifies this).
    halo_neighbor_only: bool = False

    @property
    def padded_nodes(self) -> int:
        return self.num_partitions * self.nodes_per_part

    def tree_flatten(self):
        children = (self.senders_global, self.receivers_local, self.edge_mask,
                    self.in_degree, self.node_mask, self.send_idx,
                    self.senders_halo, self.senders_int, self.recv_int,
                    self.mask_int, self.senders_bnd, self.recv_bnd,
                    self.mask_bnd, self.dia_values,
                    self.edata, self.ndata, self.gdata)
        aux = (self.num_partitions, self.nodes_per_part, self.num_nodes,
               self.num_edges, self.halo_size, self.dia_offsets,
               self.num_graphs, self.halo_neighbor_only)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        (senders_global, receivers_local, edge_mask, in_degree, node_mask,
         send_idx, senders_halo, senders_int, recv_int, mask_int,
         senders_bnd, recv_bnd, mask_bnd, dia_values, edata,
         ndata, gdata) = children
        P, npp, n, e, h, doffs, ng, nbr = aux
        return cls(senders_global, receivers_local, edge_mask, in_degree,
                   node_mask, P, npp, n, e, h, send_idx, senders_halo,
                   senders_int, recv_int, mask_int, senders_bnd, recv_bnd,
                   mask_bnd, dia_values, doffs,
                   dict(edata), dict(ndata), dict(gdata), ng,
                   halo_neighbor_only=nbr)


def partition_graph(
    g: GnnGraph,
    num_partitions: int,
    *,
    pad_edges_to_multiple: int = 128,
    halo: bool = True,
    pad_halo_to_multiple: int = 8,
    dia: bool = True,
    dia_dtype=None,
) -> PartitionedGraph:
    """Partition ``g`` by receiver into contiguous node blocks.

    With ``halo=True`` (default) the targeted-exchange metadata is built:
    each device sends only the boundary rows its peers' edges reference
    (all_to_all halo) instead of all-gathering every node row. For spatially
    ordered meshes the halo volume is a small fraction of the node count.

    ``dia=True`` (default) additionally stores each partition's INTERIOR
    edges as scalar diagonals when they form a stencil (strip partitions of
    grids), so the sharded SpMM runs the XLA stencil on the local block
    while the halo exchange is in flight.
    """
    P = num_partitions
    if g.host_coo is not None:
        s, r = g.host_coo  # no device→host read
    else:
        s = np.asarray(g.senders)
        r = np.asarray(g.receivers)
    N, E = g.num_nodes, g.num_edges

    npp = -(-N // P)  # nodes per partition (ceil)
    part_of_edge = r // npp

    counts = np.bincount(part_of_edge, minlength=P)
    e_max = int(counts.max()) if E else pad_edges_to_multiple
    e_max = -(-e_max // pad_edges_to_multiple) * pad_edges_to_multiple

    senders_g = np.zeros((P, e_max), np.int32)
    recv_l = np.zeros((P, e_max), np.int32)
    emask = np.zeros((P, e_max), np.float32)
    order = np.argsort(part_of_edge * (N + 1) + r, kind="stable")
    s_sorted, r_sorted, p_sorted = s[order], r[order], part_of_edge[order]
    offsets = np.concatenate([[0], np.cumsum(counts)])
    for p in range(P):
        lo, hi = offsets[p], offsets[p + 1]
        n = hi - lo
        senders_g[p, :n] = s_sorted[lo:hi]
        recv_l[p, :n] = r_sorted[lo:hi] - p * npp
        emask[p, :n] = 1.0

    # per-partition edge features, permuted/padded like the edge arrays
    edata = {}
    for key, val in g.edata.items():
        val = np.asarray(val)
        blk = np.zeros((P, e_max) + val.shape[1:], val.dtype)
        for p in range(P):
            lo, hi = offsets[p], offsets[p + 1]
            blk[p, : hi - lo] = val[order[lo:hi]]
        edata[key] = jnp.asarray(blk)

    deg = np.bincount(r, minlength=P * npp).astype(np.float32)
    in_degree = deg.reshape(P, npp)
    nmask = np.zeros((P, npp), np.float32)
    flat = np.arange(P * npp)
    nmask.reshape(-1)[flat < N] = 1.0

    halo_size = 0
    send_idx = None
    senders_halo = None
    neighbor_only = False
    if halo:
        # Vectorized targeted-halo construction (O(E log E), no Python
        # per-edge loops — the r1 dict build was a liability at 10M+ edges):
        # for each (needer q, owner p) pair, the unique sender rows q's
        # edges reference that p owns, plus the edge remap into q's
        # local+halo table.
        q_of_edge = np.repeat(np.arange(P, dtype=np.int64),
                              np.diff(offsets))
        owner = s_sorted // npp
        remote_mask = owner != q_of_edge
        re_q = q_of_edge[remote_mask]
        re_p = owner[remote_mask]
        re_s = s_sorted[remote_mask]
        # unique (q, p, sender) triples, sorted — matches np.unique order
        key = (re_q * P + re_p) * (N + 1) + re_s
        uniq_key, inv = np.unique(key, return_inverse=True)
        u_q = uniq_key // (P * (N + 1))
        u_p = (uniq_key // (N + 1)) % P
        u_s = uniq_key % (N + 1)
        # rank of each unique sender within its (q, p) group
        group = u_q * P + u_p
        first_of_group = np.concatenate(
            [[0], np.flatnonzero(np.diff(group)) + 1]) if len(group) else \
            np.zeros(0, np.int64)
        group_id_of_u = np.searchsorted(first_of_group, np.arange(len(group)),
                                        side="right") - 1 if len(group) else \
            np.zeros(0, np.int64)
        rank = np.arange(len(group)) - first_of_group[group_id_of_u] \
            if len(group) else np.zeros(0, np.int64)
        group_sizes = np.diff(np.concatenate([first_of_group, [len(group)]])) \
            if len(group) else np.zeros(0, np.int64)
        H = int(group_sizes.max()) if len(group_sizes) else 0
        H = max(-(-max(H, 1) // pad_halo_to_multiple) * pad_halo_to_multiple,
                pad_halo_to_multiple)
        halo_size = H
        # strip partitions of spatially ordered meshes only exchange with
        # adjacent partitions — the halo then rides 2 neighbor ppermutes
        # instead of a dense all_to_all (halo.py _exchange_halo)
        neighbor_only = bool(len(group) == 0
                             or np.all(np.abs(u_q - u_p) <= 1))
        send_idx = np.zeros((P, P, H), np.int32)
        if len(group):
            send_idx[u_p, u_q, rank] = (u_s - u_p * npp).astype(np.int32)
        # remap every edge: own -> local row, remote -> npp + p*H + rank
        slot_of_remote = npp + u_p[inv] * H + rank[inv]
        senders_halo_flat = np.where(
            remote_mask,
            np.zeros(E, np.int64), s_sorted - q_of_edge * npp)
        senders_halo_flat[remote_mask] = slot_of_remote
        senders_halo = np.zeros((P, e_max), np.int32)
        own_by_part = []
        for q in range(P):
            lo, hi = offsets[q], offsets[q + 1]
            senders_halo[q, :hi - lo] = senders_halo_flat[lo:hi]
            own_by_part.append(~remote_mask[lo:hi])

        # Interior/boundary split: interior edges (local sender) aggregate
        # while the all_to_all is in flight; boundary edges read the received
        # halo rows afterwards. Receiver-sorted order is preserved by the
        # stable boolean selection.
        ei_counts = [int(o.sum()) for o in own_by_part]
        eb_counts = [int((~o).sum()) for o in own_by_part]
        pad = pad_edges_to_multiple
        ei_max = max(-(-max(ei_counts + [1]) // pad) * pad, pad)
        eb_max = max(-(-max(eb_counts + [1]) // pad) * pad, pad)
        s_int = np.zeros((P, ei_max), np.int32)
        r_int = np.zeros((P, ei_max), np.int32)
        m_int = np.zeros((P, ei_max), np.float32)
        s_bnd = np.zeros((P, eb_max), np.int32)
        r_bnd = np.zeros((P, eb_max), np.int32)
        m_bnd = np.zeros((P, eb_max), np.float32)
        for q in range(P):
            lo, hi = offsets[q], offsets[q + 1]
            own = own_by_part[q]
            ni, nb = ei_counts[q], eb_counts[q]
            s_int[q, :ni] = senders_halo[q, :hi - lo][own]
            r_int[q, :ni] = recv_l[q, :hi - lo][own]
            m_int[q, :ni] = 1.0
            # boundary senders index the received halo rows directly
            s_bnd[q, :nb] = senders_halo[q, :hi - lo][~own] - npp
            r_bnd[q, :nb] = recv_l[q, :hi - lo][~own]
            m_bnd[q, :nb] = 1.0

    split_kw = {}
    if senders_halo is not None:
        send_idx = jnp.asarray(send_idx)
        senders_halo = jnp.asarray(senders_halo)
        split_kw = dict(
            senders_int=jnp.asarray(s_int), recv_int=jnp.asarray(r_int),
            mask_int=jnp.asarray(m_int[..., None]),
            senders_bnd=jnp.asarray(s_bnd), recv_bnd=jnp.asarray(r_bnd),
            mask_bnd=jnp.asarray(m_bnd[..., None]),
        )
        if dia:
            split_kw.update(_build_partition_dia(
                s_int, r_int, m_int, P, npp, dia_dtype))

    return PartitionedGraph(
        senders_global=jnp.asarray(senders_g),
        receivers_local=jnp.asarray(recv_l),
        edge_mask=jnp.asarray(emask[..., None]),
        in_degree=jnp.asarray(in_degree),
        node_mask=jnp.asarray(nmask[..., None]),
        num_partitions=P,
        nodes_per_part=npp,
        num_nodes=N,
        num_edges=E,
        halo_size=halo_size,
        send_idx=send_idx,
        senders_halo=senders_halo,
        halo_neighbor_only=neighbor_only,
        edata=edata,
        ndata={k: jnp.asarray(np.concatenate(
            [np.asarray(v),
             np.zeros((P * npp - N,) + np.asarray(v).shape[1:],
                      np.asarray(v).dtype)], axis=0))
               for k, v in g.ndata.items()},
        gdata={k: jnp.asarray(np.asarray(v)) for k, v in g.gdata.items()},
        num_graphs=g.num_graphs,
        **split_kw,
    )


def _build_partition_dia(s_int, r_int, m_int, P, npp, dtype,
                         max_diags: int = 32):
    """Per-partition DIA (scalar-diagonal) storage of the interior edges —
    the stencil fast path inside shard_map. Strip partitions of regular
    grids keep the global stencil offsets, so the union across partitions
    stays tiny; unstructured interiors fail the gate and keep the gather
    path. The offset tuple is the symmetric union of the interior
    offsets."""
    valid = m_int > 0
    sl = s_int[valid].astype(np.int64)
    rl = r_int[valid].astype(np.int64)
    qv = np.broadcast_to(np.arange(P)[:, None], m_int.shape)[valid]
    offs_fwd = np.unique(sl - rl)
    if len(offs_fwd) == 0:
        return {}
    offs = np.unique(np.concatenate([offs_fwd, -offs_fwd]))
    # refuse unstructured interiors: many diagonals, or a large fraction of
    # all possible local offsets (tiny partitions are trivially "diagonal")
    if (len(offs) > max_diags or np.abs(offs).max() > 8192
            or len(offs) > max(0.6 * (2 * npp - 1), 2)):
        return {}
    K = len(offs)
    jdtype = (jnp.bfloat16 if dtype in ("bfloat16", jnp.bfloat16)
              else jnp.float32)

    def scatter(src, dst):
        k = np.searchsorted(offs, src - dst)
        vals = np.zeros((P, npp, K), np.float32)
        np.add.at(vals, (qv, dst, k), 1.0)
        return jnp.asarray(vals).astype(jdtype)

    return dict(dia_values=scatter(sl, rl),
                dia_offsets=tuple(int(d) for d in offs))


def reorder_for_partition(g: GnnGraph, num_partitions: int):
    """Relabel nodes so a degree-balanced partition becomes contiguous.

    Uses the native greedy partitioner (csrc/graph_ops.cpp) to assign each
    node's receiver-edge block to the lightest partition, then permutes node
    ids so each partition's nodes are contiguous — the layout
    ``partition_graph`` expects. Returns ``(g_relabeled, perm)`` where
    ``perm[new_id] = old_id`` (permute features/labels with ``x[perm]``).
    """
    from .. import native

    if g.host_coo is not None:
        s, r = g.host_coo
    else:
        s, r = np.asarray(g.senders), np.asarray(g.receivers)
    part = native.greedy_partition(r, g.num_nodes, num_partitions)
    perm = np.argsort(part * (g.num_nodes + 1) + np.arange(g.num_nodes),
                      kind="stable").astype(np.int64)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(g.num_nodes)
    g2 = GnnGraph.from_coo(
        inv[s].astype(np.int32), inv[r].astype(np.int32),
        num_nodes=g.num_nodes,
        ndata={k: np.asarray(v)[perm] for k, v in g.ndata.items()},
        edata=g.edata or None,
        gdata=g.gdata or None,
    )
    return g2, perm


def pad_node_features(x: np.ndarray, pg: PartitionedGraph) -> np.ndarray:
    """Pad (N, F) node features to (P * nodes_per_part, F)."""
    pad = pg.padded_nodes - x.shape[0]
    if pad == 0:
        return x
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)


def unpad_node_features(x, pg: PartitionedGraph):
    return x[: pg.num_nodes]
