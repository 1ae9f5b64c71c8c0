"""Distributed layer wrappers: sharded GCN and a distributed GRAND model.

These mirror the single-device layers' math but consume a
``PartitionedGraph`` from state and run their aggregation through
``sharded_spmm``'s halo exchange. Parity with the single-device layers is
tested on a virtual CPU mesh (tests/test_parallel.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from ..nn.basic import Dense, glorot_uniform, resolve_activation, zeros_init
from ..nn.core import Layer
from ..ode.neural_ode import NeuralGraphODE
from .halo import GRAPH_AXIS, sharded_gcn_forward
from .partition import PartitionedGraph


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedGCNConv(Layer):
    """GCNConv over an edge-partitioned graph on a device mesh.

    The graph must already contain self-loops if desired (add them before
    ``partition_graph`` — runtime self-loop insertion would invalidate the
    static partition).
    """

    in_chs: int
    out_chs: int
    activation: Union[None, str, Callable] = None
    mesh: Optional[Mesh] = None
    axis_name: str = GRAPH_AXIS
    initialgraph: Optional[Callable] = None
    init_weight: Callable = glorot_uniform
    init_bias: Callable = zeros_init
    use_bias: bool = True

    def initialparameters(self, rng):
        wk, bk = jax.random.split(rng)
        ps = {"weight": self.init_weight(wk, (self.in_chs, self.out_chs))}
        if self.use_bias:
            ps["bias"] = self.init_bias(bk, (1, self.out_chs))
        return ps

    def initialstates(self, rng):
        return {"graph": self.initialgraph() if self.initialgraph else None}

    def __call__(self, x, ps, st):
        pg: PartitionedGraph = st["graph"]
        y = sharded_gcn_forward(
            pg, x, ps["weight"], ps.get("bias"), self.mesh,
            activation=resolve_activation(self.activation),
            axis_name=self.axis_name)
        return y, st


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedVMHConv(Layer):
    """Edge-partitioned VMHConv: ``m_i = mean_j ϕ(h_i, h_j−h_i, x_j−x_i)``;
    ``h_i' = γ(h_i, m_i)`` (single-device math: nn/conv.py VMHConv,
    reference src/layers.jl:241-332). Positions ride the halo exchange
    concatenated with the embeddings, so one all_to_all serves the whole
    message. Requires ``partition_graph(g, P, halo=True)`` with
    ``ndata['x']`` present."""

    phi: Layer
    gamma: Layer
    mesh: Optional[Mesh] = None
    aggr: str = "mean"
    axis_name: str = GRAPH_AXIS
    initialgraph: Optional[Callable] = None

    def initialparameters(self, rng):
        k1, k2 = jax.random.split(rng)
        return {"phi": self.phi.initialparameters(k1),
                "gamma": self.gamma.initialparameters(k2)}

    def initialstates(self, rng):
        k1, k2 = jax.random.split(rng)
        return {"phi": self.phi.initialstates(k1),
                "gamma": self.gamma.initialstates(k2),
                "graph": self.initialgraph() if self.initialgraph else None}

    def __call__(self, x, ps, st):
        from .halo import sharded_propagate

        pg: PartitionedGraph = st["graph"]
        pos = pg.ndata["x"]
        fh = x.shape[-1]
        x_aug = jnp.concatenate([x, pos.astype(x.dtype)], axis=-1)
        cell = {"phi": st["phi"]}

        def edge_feats(xi, xj, e):
            hi, posi = xi[:, :fh], xi[:, fh:]
            hj, posj = xj[:, :fh], xj[:, fh:]
            return jnp.concatenate([hi, hj - hi, posj - posi], axis=-1)

        def message(xi, xj, e):
            m, cell["phi"] = self.phi(edge_feats(xi, xj, e), ps["phi"],
                                      cell["phi"])
            return m

        # fused_phi: a Dense-stack ϕ takes the per-partition fused
        # ϕ-then-sum path (else `message` is the path)
        m = sharded_propagate(pg, message, x_aug, self.mesh, aggr=self.aggr,
                              axis_name=self.axis_name,
                              fused_phi=(self.phi, ps["phi"], edge_feats))
        y, st_gamma = self.gamma(
            jnp.concatenate([x, m], axis=-1), ps["gamma"], st["gamma"])
        return y, {**st, "phi": cell["phi"], "gamma": st_gamma}


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedMPPDEConv(Layer):
    """Edge-partitioned MPPDEConv (single-graph partitions): the message
    ``ϕ(h_i, h_j, u_i−u_j, x_i−x_j, θ)`` reads ``u``/``x`` from the
    partition's node features, exchanged with the embeddings in one halo.

    θ follows the reference's gdata contract (src/layers.jl:397): read from
    ``pg.gdata`` (concatenated across keys in declaration order, with
    stop_gradient) and broadcast per-edge/per-node. It is tiny and
    replicated, so the broadcast is free of communication. Batched graphs
    (num_graphs > 1) are not supported distributed — a batch member's nodes
    would straddle partitions; batch on the data-parallel axis instead."""

    phi: Layer
    psi: Layer
    mesh: Optional[Mesh] = None
    aggr: str = "mean"
    axis_name: str = GRAPH_AXIS
    initialgraph: Optional[Callable] = None

    def initialparameters(self, rng):
        k1, k2 = jax.random.split(rng)
        return {"phi": self.phi.initialparameters(k1),
                "psi": self.psi.initialparameters(k2)}

    def initialstates(self, rng):
        k1, k2 = jax.random.split(rng)
        return {"phi": self.phi.initialstates(k1),
              "psi": self.psi.initialstates(k2),
              "graph": self.initialgraph() if self.initialgraph else None}

    def __call__(self, x, ps, st):
        from .halo import sharded_propagate

        pg: PartitionedGraph = st["graph"]
        if pg.num_graphs != 1:
            raise ValueError(
                "ShardedMPPDEConv supports single graphs only (got "
                f"num_graphs={pg.num_graphs}); put batch members on the "
                "data-parallel axis")
        nd = [pg.ndata[k] for k in pg.ndata]  # declaration order
        fh = x.shape[-1]
        x_aug = jnp.concatenate(
            [x] + [v.astype(x.dtype) for v in nd], axis=-1)
        if pg.gdata:
            theta = jax.lax.stop_gradient(jnp.concatenate(
                [v.reshape(1, -1).astype(x.dtype) for v in pg.gdata.values()],
                axis=-1))
        else:
            theta = jnp.zeros((1, 0), x.dtype)
        cell = {"phi": st["phi"]}

        def edge_feats(xi, xj, e):
            hi, hj = xi[:, :fh], xj[:, :fh]
            di, dj = xi[:, fh:], xj[:, fh:]
            th = jnp.broadcast_to(theta, (hi.shape[0], theta.shape[1]))
            return jnp.concatenate([hi, hj, di - dj, th], axis=-1)

        def message(xi, xj, e):
            m, cell["phi"] = self.phi(edge_feats(xi, xj, e), ps["phi"],
                                      cell["phi"])
            return m

        # θ is replicated gdata, so its per-edge broadcast is free — the
        # fused path sees it as ordinary trailing feature columns
        m = sharded_propagate(pg, message, x_aug, self.mesh, aggr=self.aggr,
                              axis_name=self.axis_name,
                              fused_phi=(self.phi, ps["phi"], edge_feats))
        th_n = jnp.broadcast_to(theta, (x.shape[0], theta.shape[1]))
        y, st_psi = self.psi(
            jnp.concatenate([x, m, th_n], axis=-1), ps["psi"], st["psi"])
        return y, {**st, "phi": cell["phi"], "psi": st_psi}


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedGNOConv(Layer):
    """Edge-partitioned GNOConv: per-edge kernel MLP over gathered ndata
    pairs (through the halo), per-edge matvec, receiver mean/sum."""

    in_chs: int
    out_chs: int
    phi: Layer
    activation: Optional[str] = None
    mesh: Optional[Mesh] = None
    aggr: str = "mean"
    use_bias: bool = True
    axis_name: str = GRAPH_AXIS
    initialgraph: Optional[Callable] = None

    def __post_init__(self):
        object.__setattr__(
            self, "linear",
            Dense(self.in_chs, self.out_chs, None, use_bias=self.use_bias))

    def initialparameters(self, rng):
        k1, k2 = jax.random.split(rng)
        return {"linear": self.linear.initialparameters(k1),
                "phi": self.phi.initialparameters(k2)}

    def initialstates(self, rng):
        k1, k2 = jax.random.split(rng)
        return {"linear": self.linear.initialstates(k1),
                "phi": self.phi.initialstates(k2),
                "graph": self.initialgraph() if self.initialgraph else None}

    def __call__(self, x, ps, st):
        from .halo import sharded_propagate

        pg: PartitionedGraph = st["graph"]
        nd = [pg.ndata[k] for k in pg.ndata]  # declaration order
        fh = x.shape[-1]
        x_aug = jnp.concatenate(
            [x] + [v.astype(x.dtype) for v in nd], axis=-1)
        cell = {"phi": st["phi"]}

        def message(xi, xj, e):
            hi_s, si = xi[:, :fh], xi[:, fh:]
            hj, sj = xj[:, :fh], xj[:, fh:]
            w, cell["phi"] = self.phi(
                jnp.concatenate([si, sj], axis=-1), ps["phi"],
                cell["phi"])
            w = w.reshape(-1, self.in_chs, self.out_chs)
            return jnp.einsum("eio,ei->eo", w, hj)

        m = sharded_propagate(pg, message, x_aug, self.mesh,
                              aggr=self.aggr, axis_name=self.axis_name)
        y = jnp.dot(x, ps["linear"]["weight"],
                    preferred_element_type=x.dtype) + m
        if self.use_bias:
            y = y + ps["linear"]["bias"]
        from ..nn.basic import resolve_activation

        return resolve_activation(self.activation)(y), {
            **st, "phi": cell["phi"]}


def sharded_grand_model(
    in_dims: int,
    hidden_dims: int,
    out_dims: int,
    mesh: Mesh,
    *,
    tspan: Tuple[float, float] = (0.0, 1.0),
    solver: str = "tsit5",
    rtol: float = 1e-3,
    atol: float = 1e-3,
    initialgraph: Optional[Callable] = None,
    rhs_depth: int = 2,
    steps_per_interval: int = 16,
):
    """Distributed GRAND: encoder GCN → GCN-chain neural ODE → decoder, all
    row-sharded over the mesh's graph axis (params replicated — DP/graph
    hybrid per SURVEY §2.3 plan). ``steps_per_interval`` applies to
    fixed-grid solvers (euler/midpoint/heun/rk4)."""
    from ..nn.basic import Chain

    rhs = Chain(tuple(
        ShardedGCNConv(hidden_dims, hidden_dims, "tanh", mesh=mesh,
                       initialgraph=initialgraph)
        for _ in range(rhs_depth)))
    node = NeuralGraphODE(rhs, tspan=tspan, solver=solver, rtol=rtol,
                          atol=atol, output="last",
                          steps_per_interval=steps_per_interval)
    return Chain((
        ShardedGCNConv(in_dims, hidden_dims, "relu", mesh=mesh,
                       initialgraph=initialgraph),
        node,
        Dense(hidden_dims, out_dims),
    ))
