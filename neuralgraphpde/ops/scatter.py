"""Gather / segment-reduction primitives (XLA path).

The functional core that replaces NNlib(CUDA)'s scatter/gather kernels
underneath the reference's ``propagate`` (SURVEY §1 L1; reference
src/NeuralGraphPDE.jl:13). XLA lowers ``segment_sum`` over sorted segment
ids to a fused gather + scatter-add.

All reductions map ``(num_edges, F)`` edge values onto ``(num_segments, F)``
rows. Supported reductions mirror the reference's pluggable ``aggr``
(``+ * max min mean``, reference src/layers.jl:49).
"""
from __future__ import annotations

from typing import Callable, Union

import jax
import jax.numpy as jnp

Reduction = Union[str, Callable]

_ALIASES = {
    "+": "sum", "add": "sum", "sum": "sum",
    "*": "prod", "mul": "prod", "prod": "prod",
    "max": "max", "min": "min", "mean": "mean",
}


def canonical_reduction(aggr: Reduction) -> str:
    if callable(aggr):
        name = getattr(aggr, "__name__", None)
        if name in _ALIASES:
            return _ALIASES[name]
        raise ValueError(f"unsupported aggregation callable {aggr}")
    if aggr in _ALIASES:
        return _ALIASES[aggr]
    raise ValueError(f"unsupported aggregation {aggr!r}")


def gather(x: jax.Array, idx: jax.Array) -> jax.Array:
    """Row-gather ``x[idx]`` — edge-expansion of node features."""
    return jnp.take(x, idx, axis=0)


def segment_sum(values, segment_ids, num_segments, *, indices_are_sorted=False):
    return jax.ops.segment_sum(values, segment_ids, num_segments,
                               indices_are_sorted=indices_are_sorted)


def segment_mean(values, segment_ids, num_segments, *, indices_are_sorted=False):
    total = jax.ops.segment_sum(values, segment_ids, num_segments,
                                indices_are_sorted=indices_are_sorted)
    counts = jax.ops.segment_sum(
        jnp.ones((values.shape[0],), values.dtype), segment_ids, num_segments,
        indices_are_sorted=indices_are_sorted)
    counts = jnp.maximum(counts, 1)
    return total / counts.reshape((-1,) + (1,) * (values.ndim - 1))


def segment_max(values, segment_ids, num_segments, *, indices_are_sorted=False):
    return jax.ops.segment_max(values, segment_ids, num_segments,
                               indices_are_sorted=indices_are_sorted)


def segment_min(values, segment_ids, num_segments, *, indices_are_sorted=False):
    return jax.ops.segment_min(values, segment_ids, num_segments,
                               indices_are_sorted=indices_are_sorted)


def segment_prod(values, segment_ids, num_segments, *, indices_are_sorted=False):
    return jax.ops.segment_prod(values, segment_ids, num_segments,
                                indices_are_sorted=indices_are_sorted)


_SEGMENT_FNS = {
    "sum": segment_sum,
    "mean": segment_mean,
    "max": segment_max,
    "min": segment_min,
    "prod": segment_prod,
}


def segment_reduce(
    values: jax.Array,
    segment_ids: jax.Array,
    num_segments: int,
    aggr: Reduction = "sum",
    *,
    indices_are_sorted: bool = False,
) -> jax.Array:
    """Dispatch on the reduction name. Empty segments produce the reduction
    identity (0 for sum/mean, 1 for prod, ∓inf-replaced-by-0 semantics follow
    jax.ops for max/min)."""
    fn = _SEGMENT_FNS[canonical_reduction(aggr)]
    return fn(values, segment_ids, num_segments,
              indices_are_sorted=indices_are_sorted)
