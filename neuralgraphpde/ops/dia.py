"""Scalar-diagonal (DIA / stencil) sparse storage — the structured-mesh
path.

A regular grid mesh's adjacency has all nonzeros on a handful of SCALAR
diagonals: the 512×512 8-neighborhood grid (bench mesh; the MP-PDE / GNO
configs' meshes) has exactly 9 offsets {0, ±1, ±(nx−1), ±nx, ±(nx+1)}. The
block-banded format (``ops.bsr.BandedMatrix``) must store every block the
diagonals touch — ~200× zero inflation on that mesh (939 MB of bands) — while
DIA stores one value per EDGE: ``values[i, k] = A[i, i + offsets[k]]``,
9·N floats (4.7 MB bf16).

The SpMM becomes a stencil: ``out[i] = Σ_k values[k, i] · x[i + offsets[k]]``
— shifted reads of ``x`` weighted per-node, no gather: XLA fuses the K
shifted multiply-adds into one loop. Traffic per pass: ``x``, the small
value diagonals, and one output write.

Transpose for the backward pass: ``Aᵀ`` has offsets ``−d`` with values
shifted by ``d`` (``valuesᵀ[i, k] = values[i + d, k']``).

Build is gated: graphs whose edges span more than ``max_diags`` distinct
offsets (unstructured: random, Delaunay even after RCM) return None and keep
the gather path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True, eq=False)
class DiaMatrix:
    """values[i, k] = A[i, i + offsets[k]] (0 where absent / out of range)."""

    values: jax.Array  # (num_nodes, K) f32/bf16
    offsets: tuple  # static scalar offsets, ascending
    num_nodes: int

    @property
    def bandwidth(self) -> int:
        return max(abs(d) for d in self.offsets) if self.offsets else 0

    def tree_flatten(self):
        return ((self.values,), (self.offsets, self.num_nodes))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)


@dataclasses.dataclass(frozen=True)
class DiaPlan:
    """Decision summary from one ``sender − receiver`` offsets pass: which
    DIA representation (full / hybrid / none) ``precompute`` should build,
    so at most one O(E) value fill is made."""

    full_ok: bool  # few enough distinct offsets for full DIA
    full_bw: int  # bandwidth of full DIA (max |offset|)
    hybrid_ok: bool  # a kept-diagonals + small-remainder split exists
    hybrid_bw: int  # bandwidth of the kept diagonals


def plan_dia(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    *,
    max_diags: int = 32,
    bw_limit: int = 8192,
    min_fill: float = 0.25,
    rem_frac: float = 0.05,
) -> Optional[DiaPlan]:
    """Single ``np.unique`` pass over edge offsets → build decision. The
    gates mirror ``build_dia`` (count ≤ max_diags) and ``build_dia_hybrid``
    (kept diagonals: |offset| ≤ bw_limit, fill ≥ min_fill·N, top-max_diags
    by population; remainder 0 < rem ≤ rem_frac·E)."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    E = senders.shape[0]
    if E == 0:
        return None
    d = senders - receivers
    offsets, counts = np.unique(d, return_counts=True)
    full_ok = len(offsets) <= max_diags
    full_bw = int(np.abs(offsets).max())
    good = (np.abs(offsets) <= bw_limit) & (counts >= min_fill * num_nodes)
    if good.sum() > max_diags:
        order = np.argsort(np.where(good, counts, -1))[::-1][:max_diags]
        good = np.zeros_like(good)
        good[order] = True
    hybrid_ok, hybrid_bw = False, 0
    if good.any():
        n_rem = int(counts[~good].sum())
        hybrid_ok = 0 < n_rem <= rem_frac * E
        hybrid_bw = int(np.abs(offsets[good]).max())
    return DiaPlan(full_ok=full_ok, full_bw=full_bw,
                   hybrid_ok=hybrid_ok, hybrid_bw=hybrid_bw)


def build_dia(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    *,
    edge_weight: Optional[np.ndarray] = None,
    max_diags: int = 32,
    dtype=np.float32,
) -> Optional[DiaMatrix]:
    """Host-side DIA build; None when the graph isn't diagonal-structured
    (more than ``max_diags`` distinct ``sender − receiver`` offsets)."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    E = senders.shape[0]
    w = (np.ones(E, np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32).reshape(-1))
    d = senders - receivers
    offsets = np.unique(d)
    if len(offsets) > max_diags:
        return None
    vals = np.zeros((num_nodes, len(offsets)), np.float32)
    k = np.searchsorted(offsets, d)
    # duplicate edges accumulate (multigraph semantics match segment_sum)
    np.add.at(vals, (receivers, k), w)
    return DiaMatrix(values=jnp.asarray(vals.astype(dtype)),
                     offsets=tuple(int(o) for o in offsets),
                     num_nodes=num_nodes)


def build_dia_hybrid(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    *,
    edge_weight: Optional[np.ndarray] = None,
    max_diags: int = 32,
    dtype=np.float32,
    bw_limit: int = 8192,
    min_fill: float = 0.25,
    rem_frac: float = 0.05,
):
    """Almost-DIA graphs: stencil bulk + tiny COO remainder.

    Keeps the populous, kernel-reachable diagonals (fill ≥ ``min_fill``·N
    and |offset| ≤ ``bw_limit`` — far diagonals are mostly empty and would
    pad the stencil with zeros) and spills
    every other edge to a receiver-sorted COO remainder. The canonical case
    is a periodic grid (MP-PDE's Burgers domain): the interior stencil is
    pure DIA, the wrap edges (~1/nx of E) land on ±(n−ny)-ish offsets and
    become the remainder. Returns ``(DiaMatrix, rem_s, rem_r, rem_w)`` with
    numpy remainder arrays, or None when the split isn't worth it (no kept
    diagonal, or remainder > ``rem_frac``·E — unstructured graphs).
    """
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    E = senders.shape[0]
    if E == 0:
        return None
    w = (np.ones(E, np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32).reshape(-1))
    d = senders - receivers
    offsets, inv, counts = np.unique(d, return_inverse=True,
                                     return_counts=True)
    good = (np.abs(offsets) <= bw_limit) & (counts >= min_fill * num_nodes)
    if good.sum() > max_diags:
        # most-populous first among the eligible
        order = np.argsort(np.where(good, counts, -1))[::-1][:max_diags]
        good = np.zeros_like(good)
        good[order] = True
    if not good.any():
        return None
    keep_edge = good[inv]
    rem = ~keep_edge
    n_rem = int(rem.sum())
    if n_rem == 0:  # pure DIA — caller should use build_dia directly
        return None
    if n_rem > rem_frac * E:
        return None
    dm = build_dia(senders[keep_edge], receivers[keep_edge], num_nodes,
                   edge_weight=w[keep_edge], max_diags=max_diags, dtype=dtype)
    if dm is None:
        return None
    rs, rr, rw = senders[rem], receivers[rem], w[rem]
    order = np.argsort(rr, kind="stable")  # segment_sum sorted fast path
    return (dm, rs[order].astype(np.int32), rr[order].astype(np.int32),
            rw[order].astype(np.float32))


def dia_remainder_spmm(rem, x: jax.Array, num_nodes: int) -> jax.Array:
    """The COO remainder term ``Σ_{e∉DIA} w_e · x[s_e] → r_e`` — plain jnp
    gather + sorted segment-sum, differentiable by autodiff (its transpose
    is the scatter/gather pair XLA derives)."""
    rs, rr, rw = rem
    msgs = rw[:, None].astype(x.dtype) * jnp.take(x, rs, axis=0)
    return jax.ops.segment_sum(msgs, rr, num_segments=num_nodes,
                               indices_are_sorted=True)


def transpose_dia(dm: DiaMatrix) -> DiaMatrix:
    """Aᵀ: offset −d holds values shifted by d. Pure jnp (static shifts), so
    it works both at build time and traced inside a VJP when no prebuilt
    reverse exists."""
    K = len(dm.offsets)
    n = dm.num_nodes
    offs = [-d for d in dm.offsets]
    order = sorted(range(K), key=lambda i: offs[i])
    cols = []
    for i in order:
        d = dm.offsets[i]
        # Aᵀ[j, j−d] = A[j−d, j]  →  valuesᵀ[j, col] = values[j − d, k_of(d)]
        src = dm.values[:, i]
        if d > 0:
            col = jnp.concatenate(
                [jnp.zeros((d,), src.dtype), src[: n - d]])
        elif d < 0:
            col = jnp.concatenate([src[-d:], jnp.zeros((-d,), src.dtype)])
        else:
            col = src
        cols.append(col)
    return DiaMatrix(values=jnp.stack(cols, axis=1),
                     offsets=tuple(offs[i] for i in order),
                     num_nodes=dm.num_nodes)


def dia_spmm(dm: DiaMatrix, x: jax.Array) -> jax.Array:
    """XLA stencil SpMM: ``out[i] = Σ_k values[i,k] · x[i+offsets[k]]``."""
    n, F = dm.num_nodes, x.shape[1]
    W = dm.bandwidth
    xp = jnp.pad(x.astype(jnp.float32), ((W, W), (0, 0)))
    out = jnp.zeros((n, F), jnp.float32)
    for k, d in enumerate(dm.offsets):
        seg = jax.lax.dynamic_slice_in_dim(xp, W + d, n, axis=0)
        out = out + dm.values[:, k][:, None].astype(jnp.float32) * seg
    return out.astype(x.dtype)
