"""neuralgraphpde — a neural graph PDE framework in JAX.

A from-scratch JAX/XLA rebuild of the capability surface of
NeuralGraphPDE.jl: graph containers,
message passing, the six GNN-PDE convolution layers evaluated as continuous
ODE right-hand sides, ODE solvers with checkpointed/backsolve adjoints, and
multi-device edge-partitioned execution over jax.sharding meshes.
"""

from .graph import (
    GnnGraph,
    empty_graph,
    rand_graph,
    complete_digraph,
    radius_graph,
    knn_graph,
    delaunay_graph,
    grid_graph_1d,
    grid_graph_2d,
    add_self_loops,
    degree,
    sort_by_receiver,
    csr_offsets,
    to_dense_adjacency,
    from_dense_adjacency,
    pad_graph,
    batch,
    unbatch,
)
from .ops import (
    propagate,
    apply_edges,
    aggregate_neighbors,
    copy_xi,
    copy_xj,
    xi_dot_xj,
    e_mul_xj,
    w_mul_xj,
    reduce_nodes,
    reduce_edges,
    broadcast_nodes,
    broadcast_edges,
    softmax_nodes,
    softmax_edges,
    softmax_edge_neighbors,
    segment_reduce,
    spmm,
    precompute,
    set_spmm_mode,
)
from .nn import (
    Layer,
    ContainerLayer,
    setup,
    Dense,
    Chain,
    chain,
    MLP,
    WrappedFunction,
    AbstractGNNLayer,
    AbstractGNNContainerLayer,
    ExplicitEdgeConv,
    GCNConv,
    VMHConv,
    MPPDEConv,
    GNOConv,
    SpectralConv,
)
from .nn import Precision, bf16
from .utils import drop, wrapgraph, update_graph, updategraph
from .ode import (
    NeuralGraphODE,
    diffeqsol_to_array,
    odeint,
    odeint_grid,
)

__version__ = "0.1.0"
