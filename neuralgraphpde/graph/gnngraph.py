"""Graph container.

``GnnGraph`` is the structural equivalent of the reference's ``GNNGraph``
(GraphNeuralNetworks.jl container, consumed at reference src/NeuralGraphPDE.jl:4
and throughout reference src/layers.jl), redesigned as a JAX pytree:

- COO connectivity as ``senders``/``receivers`` int32 device arrays with
  **static** ``num_nodes``/``num_edges``/``num_graphs`` (pytree aux data), so a
  graph can flow through ``jax.jit`` without retracing when only feature values
  change (the reference's ``updategraph``-per-batch pattern,
  reference docs/src/tutorials/VMH.md:134).
- Feature stores ``ndata``/``edata``/``gdata`` are plain dicts of row-major
  arrays with a leading entity dimension: ``(num_nodes, F)``, ``(num_edges, F)``,
  ``(num_graphs, F)`` — the transpose of the reference's Julia column-major
  ``(F, n)`` layout, chosen so the feature dimension is minor (contiguous
  feature rows for the gathers).
- Feature-dict keys keep their **user insertion order** (the reference
  concatenates NamedTuple values in declaration order, reference
  src/layers.jl:106,316). Plain-dict pytree flattening would re-sort keys at
  every jit boundary, so ``tree_flatten`` emits the values as an ordered tuple
  and records the key order in static aux data.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

Array = Any
FeatureDict = Dict[str, Array]

# Bare (non-dict) feature arrays are normalized under these keys, mirroring the
# reference container's behavior (bare ndata -> :x, edata -> :e, gdata -> :u;
# see reference src/layers.jl:656 reading ``st.graph.edata.e`` for bare edata).
NDATA_DEFAULT_KEY = "x"
EDATA_DEFAULT_KEY = "e"
GDATA_DEFAULT_KEY = "u"


def _normalize_features(
    data: Union[None, Array, Mapping[str, Array]],
    num_entities: int,
    default_key: str,
    what: str,
) -> FeatureDict:
    """Normalize a feature argument into a dict of 2D+ arrays.

    Key order is the mapping's insertion order — it defines feature-concat
    order in layer messages, matching the reference's NamedTuple declaration
    order (reference src/layers.jl:106,316).
    """
    if data is None:
        return {}
    if isinstance(data, Mapping):
        items = dict(data)
    else:
        items = {default_key: data}
    out = {}
    for key in items:
        arr = items[key]
        if not isinstance(arr, (jnp.ndarray, np.ndarray, jax.core.Tracer)):
            arr = jnp.asarray(arr)
        if arr.ndim == 1:
            if num_entities == 1 and arr.shape[0] != 1:
                # A bare vector for a single graph: one row of features
                # (reference: gdata = (; θ = rand(4)) with num_graphs == 1,
                # reference test/runtests.jl:59).
                arr = arr.reshape(1, -1)
            else:
                arr = arr.reshape(-1, 1)
        if arr.shape[0] != num_entities:
            raise ValueError(
                f"{what}[{key!r}] has leading dim {arr.shape[0]}, expected "
                f"{num_entities} (row-major (num_entities, features) layout)"
            )
        out[key] = arr
    return out


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True, eq=False)
class GnnGraph:
    """A (possibly batched) directed graph with node/edge/graph features.

    Edges are ``senders[k] -> receivers[k]``; message passing aggregates
    messages onto ``receivers`` (the reference's destination-node reduction,
    reference SURVEY: propagate semantics of src/layers.jl:111 etc.).
    """

    senders: Array  # (num_edges,) int32
    receivers: Array  # (num_edges,) int32
    ndata: FeatureDict
    edata: FeatureDict
    gdata: FeatureDict
    graph_indicator: Optional[Array]  # (num_nodes,) int32 node -> graph id
    num_nodes: int
    num_edges: int
    num_graphs: int = 1
    # True if ``receivers`` is non-decreasing (canonical CSR-ready order) —
    # static so kernels can specialize.
    receivers_sorted: bool = False
    # Precomputed structure cache (pytree child): e.g. ``adj`` dense adjacency
    # for the dense SpMM path, ``dia`` stencil diagonals. Filled by
    # ``neuralgraphpde.ops.spmm.precompute``; ignored by ``__eq__``.
    cache: FeatureDict = dataclasses.field(default_factory=dict)
    # Host-side NumPy copy of (senders, receivers), kept when the graph was
    # built from NumPy so host-side preprocessing (structure builds,
    # partitioning) never triggers a device→host read. NOT part of the
    # pytree — lost across jit.
    host_coo: Optional[tuple] = dataclasses.field(default=None, repr=False)

    # ---------------------------------------------------------- construction
    @classmethod
    def from_coo(
        cls,
        senders,
        receivers,
        *,
        num_nodes: Optional[int] = None,
        ndata=None,
        edata=None,
        gdata=None,
        num_graphs: int = 1,
        graph_indicator=None,
        sort_by_receiver: bool = False,
    ) -> "GnnGraph":
        # Keep a host copy when the input is host data (list/NumPy): used by
        # host-side preprocessing without device→host reads.
        host_input = not isinstance(senders, (jnp.ndarray, jax.core.Tracer))
        host_coo = None
        if host_input:
            s_np = np.asarray(senders, np.int32)
            r_np = np.asarray(receivers, np.int32)
            host_coo = (s_np, r_np)
        senders = jnp.asarray(senders, dtype=jnp.int32)
        receivers = jnp.asarray(receivers, dtype=jnp.int32)
        if senders.shape != receivers.shape or senders.ndim != 1:
            raise ValueError("senders/receivers must be equal-length 1D arrays")
        num_edges = int(senders.shape[0])
        if num_nodes is None:
            if num_edges == 0:
                num_nodes = 0
            elif host_coo is not None:
                num_nodes = int(max(host_coo[0].max(), host_coo[1].max()) + 1)
            else:
                num_nodes = int(
                    max(int(jnp.max(senders)), int(jnp.max(receivers))) + 1
                )
        ndata = _normalize_features(ndata, num_nodes, NDATA_DEFAULT_KEY, "ndata")
        edata = _normalize_features(edata, num_edges, EDATA_DEFAULT_KEY, "edata")
        gdata = _normalize_features(gdata, num_graphs, GDATA_DEFAULT_KEY, "gdata")
        receivers_sorted = False
        if sort_by_receiver and num_edges > 0:
            if host_coo is not None:
                perm_np = np.argsort(host_coo[1], kind="stable")
                host_coo = (host_coo[0][perm_np], host_coo[1][perm_np])
                senders = jnp.asarray(host_coo[0])
                receivers = jnp.asarray(host_coo[1])
                perm = jnp.asarray(perm_np)
            else:
                perm = jnp.argsort(receivers, stable=True)
                senders = senders[perm]
                receivers = receivers[perm]
            edata = {k: v[perm] for k, v in edata.items()}
            receivers_sorted = True
        elif num_edges > 0 and host_coo is not None:
            # sortedness check only on host data — never a device→host read
            r = host_coo[1]
            receivers_sorted = bool(np.all(r[1:] >= r[:-1]))
        if graph_indicator is not None:
            graph_indicator = jnp.asarray(graph_indicator, dtype=jnp.int32)
        return cls(
            senders=senders,
            receivers=receivers,
            ndata=ndata,
            edata=edata,
            gdata=gdata,
            graph_indicator=graph_indicator,
            num_nodes=num_nodes,
            num_edges=num_edges,
            num_graphs=num_graphs,
            receivers_sorted=receivers_sorted,
            host_coo=host_coo,
        )

    @classmethod
    def from_dense(cls, adj, *, ndata=None, gdata=None,
                   store_weights: Optional[bool] = None) -> "GnnGraph":
        """ADJMAT ingestion — the reference accepts adjacency-matrix graph
        storage through GNNGraphs.jl (its only ADJMAT-specific behavior is
        an assert rejecting runtime edge weights, reference
        src/layers.jl:204). Here the matrix is converted ONCE, host-side,
        to the canonical COO form: ``adj[r, s] != 0`` becomes edge
        ``s -> r`` (the receiver-major orientation of
        ``to_dense_adjacency``), receiver-sorted by construction. Non-unit
        entries are stored in ``edata['e']`` — the stored-edge-weight slot
        ``GCNConv(use_edge_weight=True)`` reads; ``store_weights`` forces
        storing (True) or dropping (False) the values. Thin constructor
        face of ``graph.transforms.from_dense_adjacency``."""
        from .transforms import from_dense_adjacency

        A = np.asarray(adj)
        if A.ndim != 2 or A.shape[0] != A.shape[1]:
            raise ValueError(f"adjacency must be square 2-D, got {A.shape}")
        g = from_dense_adjacency(A, ndata=ndata, gdata=gdata)
        if store_weights is True and "e" not in g.edata:
            g = g.replace(edata={"e": jnp.ones((g.num_edges, 1),
                                               jnp.float32)})
        elif store_weights is False and "e" in g.edata:
            g = g.replace(edata={k: v for k, v in g.edata.items()
                                 if k != "e"})
        return g

    def replace(self, **kwargs) -> "GnnGraph":
        """Constructor-copy with feature overrides.

        Equivalent of the reference's ``GNNGraph(g; ndata=..., edata=...,
        gdata=...)`` constructor-copy (reference test/runtests.jl:29,58,76).
        Structure (senders/receivers/counts) is preserved unless overridden.
        """
        for key in ("ndata", "edata", "gdata"):
            if key in kwargs:
                n = {"ndata": self.num_nodes, "edata": self.num_edges,
                     "gdata": self.num_graphs}[key]
                default = {"ndata": NDATA_DEFAULT_KEY, "edata": EDATA_DEFAULT_KEY,
                           "gdata": GDATA_DEFAULT_KEY}[key]
                kwargs[key] = _normalize_features(kwargs[key], n, default, key)
        return dataclasses.replace(self, **kwargs)

    # Shallow copy: same structure/feature arrays, new wrapper (reference
    # ``Base.copy(g::GNNGraph)`` src/utils.jl:8).
    def copy(self, **kwargs) -> "GnnGraph":
        return self.replace(**kwargs) if kwargs else dataclasses.replace(self)

    # ---------------------------------------------------------------- pytree
    # Feature dicts are flattened as ordered value-tuples with the key order
    # in static aux data: plain-dict flattening would re-sort keys at every
    # jit boundary and silently change feature-concat order (the reference's
    # concat order is NamedTuple declaration order, src/layers.jl:106,316).
    def tree_flatten(self):
        children = (
            self.senders,
            self.receivers,
            tuple(self.ndata.values()),
            tuple(self.edata.values()),
            tuple(self.gdata.values()),
            self.graph_indicator,
            tuple(self.cache.values()),
        )
        aux = (self.num_nodes, self.num_edges, self.num_graphs,
               self.receivers_sorted,
               tuple(self.ndata), tuple(self.edata), tuple(self.gdata),
               tuple(self.cache))
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        senders, receivers, nvals, evals, gvals, graph_indicator, cvals = children
        (num_nodes, num_edges, num_graphs, receivers_sorted,
         nkeys, ekeys, gkeys, ckeys) = aux
        return cls(
            senders=senders,
            receivers=receivers,
            ndata=dict(zip(nkeys, nvals)),
            edata=dict(zip(ekeys, evals)),
            gdata=dict(zip(gkeys, gvals)),
            graph_indicator=graph_indicator,
            num_nodes=num_nodes,
            num_edges=num_edges,
            num_graphs=num_graphs,
            receivers_sorted=receivers_sorted,
            cache=dict(zip(ckeys, cvals)),
        )

    # -------------------------------------------------------------- equality
    def __eq__(self, other):
        if not isinstance(other, GnnGraph):
            return NotImplemented
        if (self.num_nodes, self.num_edges, self.num_graphs) != (
            other.num_nodes, other.num_edges, other.num_graphs
        ):
            return False

        def arrays_equal(a, b):
            if a is None and b is None:
                return True
            if a is None or b is None:
                return False
            return np.array_equal(np.asarray(a), np.asarray(b))

        if not arrays_equal(self.senders, other.senders):
            return False
        if not arrays_equal(self.receivers, other.receivers):
            return False
        if not arrays_equal(self.graph_indicator, other.graph_indicator):
            return False
        for mine, theirs in ((self.ndata, other.ndata),
                             (self.edata, other.edata),
                             (self.gdata, other.gdata)):
            if set(mine) != set(theirs):
                return False
            for k in mine:
                if not arrays_equal(mine[k], theirs[k]):
                    return False
        return True

    def __repr__(self):
        feat = lambda d: {k: tuple(v.shape) for k, v in d.items()}
        return (
            f"GnnGraph(num_nodes={self.num_nodes}, num_edges={self.num_edges}, "
            f"num_graphs={self.num_graphs}, ndata={feat(self.ndata)}, "
            f"edata={feat(self.edata)}, gdata={feat(self.gdata)})"
        )


# The default "no graph yet" sentinel: models can be initialized graph-free and
# have a real graph injected later via ``update_graph`` (reference EMPTYGRAPH,
# src/layers.jl:14,21; docs/src/index.md:38-54).
def empty_graph() -> GnnGraph:
    return GnnGraph.from_coo(
        jnp.zeros((0,), jnp.int32), jnp.zeros((0,), jnp.int32), num_nodes=0
    )
