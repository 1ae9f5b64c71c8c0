"""Distributed message passing over a device mesh (shard_map + collectives).

Each RHS evaluation on an edge-partitioned graph does:
  1. local per-node scaling / pre-multiplication (sharded rows, no comm),
  2. halo exchange of sender features — a targeted ``all_to_all`` or two
     neighbour ``ppermute``s of the boundary rows (XLA hands both to NCCL),
     or a tiled ``all_gather`` when no halo metadata was built,
  3. local gather → (message) → masked segment-sum onto owned receivers.

This is the structural analog of sequence-parallel halo exchange (SURVEY
§5.7); the reference has no equivalent (single device).
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .partition import PartitionedGraph

GRAPH_AXIS = "graph"


def make_mesh(num_devices: Optional[int] = None,
              axis_name: str = GRAPH_AXIS) -> Mesh:
    devs = jax.devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    import numpy as np
    return Mesh(np.asarray(devs), (axis_name,))


def _local_spmm_block(x_block, senders_g, recv_l, emask, npp,
                      axis_name=GRAPH_AXIS):
    """Per-device body (all-gather variant): gather senders from the
    all-gathered table, mask padding, segment-sum onto owned receivers.
    Shapes inside shard_map carry a leading singleton device axis for the
    partition-major arrays."""
    x_full = jax.lax.all_gather(x_block, axis_name, axis=0, tiled=True)
    xj = jnp.take(x_full, senders_g[0], axis=0) * emask[0]
    return jax.ops.segment_sum(
        xj, recv_l[0], num_segments=npp, indices_are_sorted=True)


def _exchange_halo(send_rows, axis_name=GRAPH_AXIS, neighbor_only=False):
    """Deliver each device's per-peer halo blocks: ``send_rows`` is
    ``(P, H, F)`` (block ``q`` = rows for device ``q``); returns the same
    shape where block ``p`` = rows RECEIVED from device ``p``.

    ``neighbor_only=True`` (partition_graph detected that only adjacent
    partitions exchange rows — strip meshes): two neighbor ``ppermute``s
    ship 2·H rows per device instead of the dense all_to_all's (P-1)·H,
    keeping per-device link volume flat in P (examples/comm_model.py)."""
    if not neighbor_only:
        return jax.lax.all_to_all(send_rows, axis_name, split_axis=0,
                                  concat_axis=0, tiled=False)
    P_ = send_rows.shape[0]
    if P_ == 1:
        return jnp.zeros_like(send_rows)
    idx = jax.lax.axis_index(axis_name)
    # my blocks destined for my two neighbors (clamped picks are dummies
    # at the chain ends; the matching ppermute edge doesn't exist there)
    to_next = jax.lax.dynamic_index_in_dim(
        send_rows, jnp.minimum(idx + 1, P_ - 1), axis=0, keepdims=False)
    to_prev = jax.lax.dynamic_index_in_dim(
        send_rows, jnp.maximum(idx - 1, 0), axis=0, keepdims=False)
    from_prev = jax.lax.ppermute(
        to_next, axis_name, [(i, i + 1) for i in range(P_ - 1)])
    from_next = jax.lax.ppermute(
        to_prev, axis_name, [(i + 1, i) for i in range(P_ - 1)])
    # slot p of the table holds rows from device p: my neighbors' blocks
    # land at idx-1 / idx+1 (clamped writes at the chain ends target my
    # OWN slot, which senders_halo never references)
    tbl = jnp.zeros_like(send_rows)
    tbl = jax.lax.dynamic_update_slice_in_dim(
        tbl, from_prev[None], idx - 1, axis=0)
    tbl = jax.lax.dynamic_update_slice_in_dim(
        tbl, from_next[None], idx + 1, axis=0)
    return tbl


def _halo_table(x_block, send_idx_p, axis_name=GRAPH_AXIS,
                neighbor_only=False):
    """Targeted halo exchange: each device sends only the boundary rows its
    peers reference. Returns the local+halo row table
    ``[x_local; rows from dev 0; rows from dev 1; ...]`` matching the
    ``senders_halo`` remapping built at partition time."""
    send_rows = jnp.take(x_block, send_idx_p[0], axis=0)  # (P, H, F)
    recv = _exchange_halo(send_rows, axis_name, neighbor_only)
    return jnp.concatenate(
        [x_block, recv.reshape(-1, x_block.shape[-1])], axis=0)


def _local_spmm_block_halo(x_block, senders_h, recv_l, emask, send_idx_p,
                           npp, axis_name=GRAPH_AXIS, neighbor_only=False):
    table = _halo_table(x_block, send_idx_p, axis_name, neighbor_only)
    xj = jnp.take(table, senders_h[0], axis=0) * emask[0]
    return jax.ops.segment_sum(
        xj, recv_l[0], num_segments=npp, indices_are_sorted=True)


def _local_spmm_block_overlap(x_block, s_int, r_int, m_int, s_bnd, r_bnd,
                              m_bnd, send_idx_p, npp, axis_name=GRAPH_AXIS,
                              neighbor_only=False):
    """Interior/boundary-split aggregation (SURVEY §5.7 overlap plan): the
    all_to_all is issued first, the interior segment-sum (no data dependence
    on it) runs while it is in flight — XLA's latency-hiding scheduler
    overlaps them — and only the short boundary pass consumes the received
    halo rows."""
    send_rows = jnp.take(x_block, send_idx_p[0], axis=0)  # (P, H, F)
    halo_rows = _exchange_halo(send_rows, axis_name, neighbor_only)
    xj_i = jnp.take(x_block, s_int[0], axis=0) * m_int[0]
    out = jax.ops.segment_sum(
        xj_i, r_int[0], num_segments=npp, indices_are_sorted=True)
    tbl = halo_rows.reshape(-1, x_block.shape[-1])
    xj_b = jnp.take(tbl, s_bnd[0], axis=0) * m_bnd[0]
    out = out + jax.ops.segment_sum(
        xj_b, r_bnd[0], num_segments=npp, indices_are_sorted=True)
    return out


def _local_spmm_block_dia_overlap(x_block, vals, s_bnd, r_bnd,
                                  m_bnd, send_idx_p, npp, offsets,
                                  axis_name=GRAPH_AXIS, neighbor_only=False):
    """Interior aggregation on the XLA stencil while the halo exchange is
    in flight; boundary edges consume the received halo rows
    (partition_graph(dia=True) on strip-partitioned stencil meshes)."""
    from ..ops.dia import DiaMatrix, dia_spmm

    send_rows = jnp.take(x_block, send_idx_p[0], axis=0)
    halo_rows = _exchange_halo(send_rows, axis_name, neighbor_only)
    out = dia_spmm(DiaMatrix(values=vals[0], offsets=offsets, num_nodes=npp),
                   x_block)
    tbl = halo_rows.reshape(-1, x_block.shape[-1])
    xj_b = jnp.take(tbl, s_bnd[0], axis=0) * m_bnd[0]
    return out + jax.ops.segment_sum(
        xj_b, r_bnd[0], num_segments=npp, indices_are_sorted=True)


def sharded_spmm(
    pg: PartitionedGraph,
    x: jax.Array,
    mesh: Mesh,
    axis_name: str = GRAPH_AXIS,
    feature_axis: Optional[str] = None,
) -> jax.Array:
    """Distributed ``out[i] = Σ_{j→i} x[j]`` over row-sharded features.

    ``x``: (padded_nodes, F) sharded ``P(axis_name, feature_axis)``. Returns
    the same sharding. Uses the targeted all_to_all halo when the partition
    carries the metadata; all_gather otherwise. With per-partition
    diagonals (``partition_graph(dia=True)`` on stencil meshes) the
    interior aggregation runs on the XLA stencil.

    ``feature_axis`` names a SECOND mesh axis sharding the feature columns
    (2-D graph x model layout): the aggregation is independent per column,
    so each model shard runs the same per-partition body on its F/size
    columns and the halo all_to_all stays entirely on ``axis_name`` — no
    cross-axis collective is ever needed.
    """
    npp = pg.nodes_per_part
    xs = P(axis_name, feature_axis)

    if pg.dia_values is not None:
        offsets = pg.dia_offsets

        def body(x_block, vals, s_bnd, r_bnd, m_bnd, send_idx):
            return _local_spmm_block_dia_overlap(
                x_block, vals, s_bnd, r_bnd, m_bnd, send_idx, npp,
                offsets, axis_name, pg.halo_neighbor_only)

        dia_spec = P(axis_name, None, None)
        f = jax.shard_map(
            body, mesh=mesh,
            in_specs=(xs, dia_spec,
                      P(axis_name, None), P(axis_name, None),
                      P(axis_name, None, None), P(axis_name, None, None)),
            out_specs=xs)
        return f(x, pg.dia_values, pg.senders_bnd,
                 pg.recv_bnd, pg.mask_bnd, pg.send_idx)

    if pg.senders_int is not None:
        # overlapped interior/boundary split (preferred halo path)
        def body(x_block, s_int, r_int, m_int, s_bnd, r_bnd, m_bnd, send_idx):
            return _local_spmm_block_overlap(
                x_block, s_int, r_int, m_int, s_bnd, r_bnd, m_bnd, send_idx,
                npp, axis_name, pg.halo_neighbor_only)

        f = jax.shard_map(
            body, mesh=mesh,
            in_specs=(xs, P(axis_name, None),
                      P(axis_name, None), P(axis_name, None, None),
                      P(axis_name, None), P(axis_name, None),
                      P(axis_name, None, None), P(axis_name, None, None)),
            out_specs=xs,
        )
        return f(x, pg.senders_int, pg.recv_int, pg.mask_int, pg.senders_bnd,
                 pg.recv_bnd, pg.mask_bnd, pg.send_idx)

    if pg.senders_halo is not None:
        def body(x_block, senders_h, recv_l, emask, send_idx):
            return _local_spmm_block_halo(x_block, senders_h, recv_l, emask,
                                          send_idx, npp, axis_name,
                                          pg.halo_neighbor_only)

        f = jax.shard_map(
            body, mesh=mesh,
            in_specs=(xs, P(axis_name, None),
                      P(axis_name, None), P(axis_name, None, None),
                      P(axis_name, None, None)),
            out_specs=xs,
        )
        return f(x, pg.senders_halo, pg.receivers_local, pg.edge_mask,
                 pg.send_idx)

    def body(x_block, senders_g, recv_l, emask):
        return _local_spmm_block(x_block, senders_g, recv_l, emask, npp,
                                 axis_name)

    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(xs, P(axis_name, None), P(axis_name, None),
                  P(axis_name, None, None)),
        out_specs=xs,
    )
    return f(x, pg.senders_global, pg.receivers_local, pg.edge_mask)


def sharded_gcn_forward(
    pg: PartitionedGraph,
    x: jax.Array,
    weight: jax.Array,
    bias: Optional[jax.Array],
    mesh: Mesh,
    *,
    activation: Callable = lambda v: v,
    axis_name: str = GRAPH_AXIS,
) -> jax.Array:
    """Distributed GCNConv forward on a pre-self-looped partitioned graph:
    symmetric degree normalization, SpMM with halo exchange, affine + act.

    Semantics match the single-device layer (reference src/layers.jl:200-239)
    including the out<in pre-multiply optimization — the pre-multiply also
    shrinks the halo-exchange payload.
    """
    in_dims, out_dims = weight.shape
    npp = pg.nodes_per_part
    use_dia = pg.dia_values is not None
    use_overlap = pg.senders_int is not None
    use_halo = pg.senders_halo is not None

    def pre(x_block, deg):
        c = jnp.where(deg > 0, 1.0 / jnp.sqrt(jnp.maximum(deg, 1e-30)),
                      0.0)[:, None]
        h = x_block
        if out_dims < in_dims:
            h = jnp.dot(h, weight, preferred_element_type=h.dtype)
        return h * c, c

    def post(agg, c, nmask):
        agg = agg * c
        if out_dims >= in_dims:
            agg = jnp.dot(agg, weight, preferred_element_type=agg.dtype)
        if bias is not None:
            agg = agg + bias
        return activation(agg) * nmask

    if use_dia:
        offsets = pg.dia_offsets

        def body(x_block, deg, nmask, vals, s_bnd, r_bnd, m_bnd,
                 send_idx):
            h, c = pre(x_block, deg[0])
            agg = _local_spmm_block_dia_overlap(
                h, vals, s_bnd, r_bnd, m_bnd, send_idx, npp,
                offsets, axis_name, pg.halo_neighbor_only)
            return post(agg, c, nmask[0])

        dia_spec = P(axis_name, None, None)
        f = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(axis_name, None), P(axis_name, None),
                      P(axis_name, None, None), dia_spec,
                      P(axis_name, None), P(axis_name, None),
                      P(axis_name, None, None), P(axis_name, None, None)),
            out_specs=P(axis_name, None))
        return f(x, pg.in_degree, pg.node_mask, pg.dia_values,
                 pg.senders_bnd, pg.recv_bnd, pg.mask_bnd,
                 pg.send_idx)

    if use_overlap:
        def body(x_block, deg, nmask, s_int, r_int, m_int, s_bnd, r_bnd,
                 m_bnd, send_idx):
            h, c = pre(x_block, deg[0])
            agg = _local_spmm_block_overlap(h, s_int, r_int, m_int, s_bnd,
                                            r_bnd, m_bnd, send_idx, npp,
                                            axis_name,
                                            pg.halo_neighbor_only)
            return post(agg, c, nmask[0])

        f = jax.shard_map(
            body, mesh=mesh,
            in_specs=(P(axis_name, None), P(axis_name, None),
                      P(axis_name, None, None), P(axis_name, None),
                      P(axis_name, None), P(axis_name, None, None),
                      P(axis_name, None), P(axis_name, None),
                      P(axis_name, None, None), P(axis_name, None, None)),
            out_specs=P(axis_name, None),
        )
        return f(x, pg.in_degree, pg.node_mask, pg.senders_int, pg.recv_int,
                 pg.mask_int, pg.senders_bnd, pg.recv_bnd, pg.mask_bnd,
                 pg.send_idx)

    def body(x_block, senders, recv_l, emask, deg, nmask, *rest):
        h, c = pre(x_block, deg[0])
        if use_halo:
            agg = _local_spmm_block_halo(h, senders, recv_l, emask, rest[0],
                                         npp, axis_name,
                                         pg.halo_neighbor_only)
        else:
            agg = _local_spmm_block(h, senders, recv_l, emask, npp, axis_name)
        return post(agg, c, nmask[0])

    base_specs = (P(axis_name, None), P(axis_name, None), P(axis_name, None),
                  P(axis_name, None, None), P(axis_name, None),
                  P(axis_name, None, None))
    if use_halo:
        f = jax.shard_map(
            body, mesh=mesh,
            in_specs=base_specs + (P(axis_name, None, None),),
            out_specs=P(axis_name, None),
        )
        return f(x, pg.senders_halo, pg.receivers_local, pg.edge_mask,
                 pg.in_degree, pg.node_mask, pg.send_idx)
    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=base_specs,
        out_specs=P(axis_name, None),
    )
    return f(x, pg.senders_global, pg.receivers_local, pg.edge_mask,
             pg.in_degree, pg.node_mask)


def sharded_propagate(
    pg: PartitionedGraph,
    message,
    x: jax.Array,
    mesh: Mesh,
    *,
    aggr: str = "sum",
    axis_name: str = GRAPH_AXIS,
    fused_phi=None,
) -> jax.Array:
    """Distributed custom-message propagate over an edge-partitioned graph.

    ``message(xi, xj, e)`` receives edge-expanded arrays (xi from local
    receiver rows, xj through the targeted halo table, e a dict of
    per-partition edge features) and returns per-edge messages, which are
    masked and segment-reduced onto owned receivers. Requires a ``halo=True``
    partition. The distributed generalization of ``ops.propagate`` for the
    custom-message layers (ExplicitEdgeConv/VMHConv/MPPDEConv/GNOConv).

    ``fused_phi=(phi, phi_ps, feats_fn)`` takes the fused ϕ-then-sum path
    PER PARTITION, the one the single-device layers take
    (``nn.conv._phi_aggregate``): ``feats_fn(xi, xj, e)`` builds the
    per-edge input features and ``nn.conv.edge_mlp_sum`` runs ϕ and the
    receiver sum.
    Engages when ϕ is a Dense stack and ``aggr`` is sum/mean — else this
    argument is ignored and ``message`` takes the exact path.
    """
    if pg.senders_halo is None:
        raise ValueError("sharded_propagate requires partition_graph(halo=True)")
    if fused_phi is not None and aggr in ("sum", "mean"):
        from ..nn.conv import fused_phi_plan

        phi, phi_ps, feats_fn = fused_phi
        plan = fused_phi_plan(phi, phi_ps, aggr)
        if plan is not None:
            return _sharded_propagate_fused(pg, feats_fn, plan, x, mesh,
                                            aggr, axis_name)
    if aggr not in ("sum", "mean", "max", "min", "prod"):
        raise ValueError(
            "distributed aggr supports 'sum'/'mean'/'max'/'min'/'prod'")
    npp = pg.nodes_per_part
    ekeys = list(pg.edata)

    # Edges are partitioned by receiver owner, so every node's full in-edge
    # set is local to one partition: non-sum reductions need no cross-device
    # combine — only the right identity element on padding edges. Empty
    # segments follow the jax.ops convention (±inf / 1), matching the
    # single-device ``segment_reduce`` path.
    def body(x_block, senders_h, recv_l, emask, send_idx, deg, *eblocks):
        table = _halo_table(x_block, send_idx, axis_name,
                            pg.halo_neighbor_only)
        xj = jnp.take(table, senders_h[0], axis=0)
        xi = jnp.take(x_block, recv_l[0], axis=0)
        e = {k: b[0] for k, b in zip(ekeys, eblocks)}
        m = message(xi, xj, e)
        mask = emask[0] > 0
        if aggr in ("sum", "mean"):
            m = m * emask[0]
            out = jax.ops.segment_sum(m, recv_l[0], num_segments=npp,
                                      indices_are_sorted=True)
            if aggr == "mean":
                out = out / jnp.maximum(deg[0], 1.0)[:, None]
        elif aggr == "max":
            m = jnp.where(mask, m, -jnp.inf)
            out = jax.ops.segment_max(m, recv_l[0], num_segments=npp,
                                      indices_are_sorted=True)
        elif aggr == "min":
            m = jnp.where(mask, m, jnp.inf)
            out = jax.ops.segment_min(m, recv_l[0], num_segments=npp,
                                      indices_are_sorted=True)
        else:  # prod
            m = jnp.where(mask, m, 1.0)
            out = jax.ops.segment_prod(m, recv_l[0], num_segments=npp,
                                       indices_are_sorted=True)
        return out

    espec = tuple(P(axis_name, None, None) for _ in ekeys)
    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name, None), P(axis_name, None),
                  P(axis_name, None, None), P(axis_name, None, None),
                  P(axis_name, None)) + espec,
        out_specs=P(axis_name, None),
    )
    return f(x, pg.senders_halo, pg.receivers_local, pg.edge_mask,
             pg.send_idx, pg.in_degree, *[pg.edata[k] for k in ekeys])


def _sharded_propagate_fused(pg: PartitionedGraph, feats_fn, plan,
                             x: jax.Array, mesh: Mesh, aggr: str,
                             axis_name: str) -> jax.Array:
    """Per-partition fused ϕ-then-sum: halo exchange → XLA feature concat →
    ``edge_mlp_sum`` over the partition's receiver-sorted edges. Padding
    edge slots get weight 0 and the last local receiver id, which keeps the
    receivers sorted; the post epilogue (mean normalization / split-off
    linear layer) uses the partition's true in-degrees, zero on padded
    nodes."""
    from ..nn.conv import edge_mlp_sum, fused_phi_post

    acts, ws, bs, post = plan
    has_post = post is not None
    npp = pg.nodes_per_part
    ekeys = list(pg.edata)

    def body(x_block, senders_h, recv_l, emask, send_idx, deg, ws_, bs_,
             post_, *eblocks):
        table = _halo_table(x_block, send_idx, axis_name,
                            pg.halo_neighbor_only)
        xj = jnp.take(table, senders_h[0], axis=0)
        xi = jnp.take(x_block, recv_l[0], axis=0)
        e = {k: b[0] for k, b in zip(ekeys, eblocks)}
        feats = feats_fn(xi, xj, e)
        wmask = emask[0][:, 0]
        recv = jnp.where(wmask > 0, recv_l[0], npp - 1)
        reduced = edge_mlp_sum(acts, feats, ws_, bs_, recv, npp,
                               weights=wmask)
        return fused_phi_post(reduced, post_ if has_post else None,
                              deg[0], aggr)

    post_ps = post if has_post else {}
    espec = tuple(P(axis_name, None, None) for _ in ekeys)
    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis_name, None), P(axis_name, None), P(axis_name, None),
                  P(axis_name, None, None), P(axis_name, None, None),
                  P(axis_name, None), P(), P(), P()) + espec,
        out_specs=P(axis_name, None),
    )
    return f(x, pg.senders_halo, pg.receivers_local, pg.edge_mask,
             pg.send_idx, pg.in_degree, ws, bs, post_ps,
             *[pg.edata[k] for k in ekeys])


def shard_node_features(x, pg: PartitionedGraph, mesh: Mesh,
                        axis_name: str = GRAPH_AXIS):
    """Place (padded_nodes, F) features row-sharded on the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P(axis_name, None)))


def replicate(tree, mesh: Mesh):
    return jax.device_put(tree, NamedSharding(mesh, P()))
