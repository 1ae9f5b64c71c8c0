"""Tensor parallelism for the layer MLPs (SURVEY §2.3: secondary strategy).

GNN-PDE models are dominated by edge-batched MLPs (``num_edges × hidden``
GEMMs). When hidden widths are large, shard the *feature* dimension of Dense
kernels over a mesh axis with ``NamedSharding`` and let XLA's SPMD partitioner
insert the collectives — the GSPMD recipe: annotate, jit, let the compiler
place all-gathers/reduce-scatters on the device links.

Convention: Dense kernels ``(in, out)`` shard on ``out`` (column parallel);
biases ``(1, out)`` likewise. Successive layers then alternate
column-/row-parallel naturally under GSPMD's propagation; no manual
collectives are written here.
"""
from __future__ import annotations

from typing import Any

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def shard_mlp_params(
    params: Any,
    mesh: Mesh,
    axis_name: str = "model",
    min_dim: int = 256,
) -> Any:
    """Place every Dense-like kernel with a large trailing dim column-sharded
    on ``axis_name``; everything else replicated.

    ``min_dim``: only shard output dims at least this large (small layers are
    cheaper replicated than gathered).
    """
    axis_size = mesh.shape[axis_name]

    def place(leaf):
        if (hasattr(leaf, "ndim") and leaf.ndim == 2
                and leaf.shape[-1] >= min_dim
                and leaf.shape[-1] % axis_size == 0):
            return jax.device_put(
                leaf, NamedSharding(mesh, P(None, axis_name)))
        return jax.device_put(leaf, NamedSharding(mesh, P()))

    return jax.tree_util.tree_map(place, params)


def replicate_params(params: Any, mesh: Mesh) -> Any:
    return jax.device_put(params, NamedSharding(mesh, P()))


def row_parallel_dense(
    x: jax.Array,
    weight: jax.Array,
    bias=None,
    *,
    mesh: Mesh,
    axis_name: str = "model",
    x_specs: P = None,
):
    """Row-parallel Dense — the pairing that CLOSES a column-parallel (or
    feature-sharded) stage: ``x`` arrives with its feature columns sharded
    on ``axis_name``, ``weight`` is row-sharded to match, each shard
    computes its partial ``x_shard @ w_shard`` and one ``psum`` over
    ``axis_name`` restores the full output (Megatron MLP pairing; the
    all-reduce rides the device links).

    Composes with ``sharded_spmm(..., feature_axis=axis_name)``: aggregate
    with 2-D graph×model sharding, then contract the model axis away here.
    ``x_specs`` gives x's full PartitionSpec (default
    ``P(None, axis_name)``); the output keeps every non-feature axis of it
    and replicates the feature axis.
    """
    if x_specs is None:
        x_specs = P(None, axis_name)
    out_specs = P(*x_specs[:-1], None)

    def body(x_block, w_block):
        partial = jax.lax.dot_general(
            x_block, w_block, dimension_numbers=(((x_block.ndim - 1,), (0,)),
                                                 ((), ())),
            preferred_element_type=x_block.dtype)
        return jax.lax.psum(partial, axis_name)

    f = jax.shard_map(
        body, mesh=mesh,
        in_specs=(x_specs, P(axis_name, None)),
        out_specs=out_specs, check_vma=False)
    y = f(x, weight)
    return y if bias is None else y + bias
