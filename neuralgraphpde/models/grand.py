"""GRAND-style neural graph diffusion for node classification.

Library-code promotion of the reference's first tutorial (reference
docs/src/tutorials/graph_node.md:77-95): an encoder GCN, a GCN-chain ODE
right-hand side integrated over ``tspan``, and a linear decoder —
``Chain(GCNConv(in→h, relu), NeuralODE(Chain(GCNConv, GCNConv)),
diffeqsol_to_array, Dense(h→classes))``.
"""
from __future__ import annotations

from typing import Optional, Tuple

from ..graph.gnngraph import GnnGraph
from ..nn.basic import Chain, Dense
from ..nn.conv import GCNConv
from ..ode.neural_ode import NeuralGraphODE


def grand_model(
    in_dims: int,
    hidden_dims: int,
    out_dims: int,
    *,
    tspan: Tuple[float, float] = (0.0, 1.0),
    solver: str = "tsit5",
    rtol: float = 1e-3,
    atol: float = 1e-3,
    adjoint: str = "checkpoint",
    steps_per_interval: int = 8,
    initialgraph: Optional[GnnGraph] = None,
    rhs_depth: int = 2,
    precomputed_self_loops: bool = False,
) -> Chain:
    """``precomputed_self_loops=True`` assumes the graph bound at runtime
    already contains self-loops (add them before ``ops.precompute`` so the
    SpMM cache — dense adjacency / DIA stencil / degrees — stays valid inside
    the ODE hot loop)."""
    asl = not precomputed_self_loops
    rhs = Chain(tuple(
        GCNConv(hidden_dims, hidden_dims, "tanh", initialgraph=initialgraph,
                add_self_loops=asl)
        for _ in range(rhs_depth)))
    node = NeuralGraphODE(
        rhs, tspan=tspan, solver=solver, rtol=rtol, atol=atol,
        adjoint=adjoint, steps_per_interval=steps_per_interval, output="last")
    return Chain((
        GCNConv(in_dims, hidden_dims, "relu", initialgraph=initialgraph,
                add_self_loops=asl),
        node,
        Dense(hidden_dims, out_dims),
    ))
