"""Block storage formats: BSR, dense block diagonals, row-packed block
bands, and their XLA products.

Spatially ordered meshes have block-banded adjacency: nonzero entries
cluster into a small set of ``TB×TB`` blocks near the diagonal, and the
aggregation can be written as batched dense block products with no per-edge
gather:

    out[row_block i] = Σ_k A_pack[k] @ x[col_block(k)]        (k: blocks of i)

No dispatch path reads these formats: on the H200, gather + sorted segment
sum on the RCM-ordered graph ran 10× faster than ``packed_banded_spmm``
(PERF.md). They remain as library functions until a cleanup removes them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True, eq=False)
class BsrMatrix:
    """Packed nonzero blocks of the (receiver, sender) adjacency."""

    blocks: jax.Array  # (nnzb, TB, TB) — A[rb*TB:, cb*TB:] dense content
    col_blocks: jax.Array  # (nnzb,) int32 — sender block index of each block
    row_blocks: jax.Array  # (nnzb,) int32 — receiver block index (sorted)
    num_row_blocks: int
    num_col_blocks: int
    tb: int
    num_nodes: int
    density: float  # nnz blocks / (row_blocks * col_blocks)

    def tree_flatten(self):
        return ((self.blocks, self.col_blocks, self.row_blocks),
                (self.num_row_blocks, self.num_col_blocks, self.tb,
                 self.num_nodes, self.density))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, *aux)


def build_bsr(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    *,
    tb: int = 256,
    edge_weight: Optional[np.ndarray] = None,
    dtype=np.float32,
) -> BsrMatrix:
    """Host-side block packing. ``A[r, s] += w`` per edge ``s -> r``."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    E = senders.shape[0]
    w = (np.ones(E, np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32).reshape(-1))

    nb = -(-num_nodes // tb)
    rb = receivers // tb
    cb = senders // tb
    key = rb * nb + cb
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, starts = np.unique(key_s, return_index=True)
    nnzb = len(uniq)

    # accumulate in f32 (np.add.at needs a native dtype), cast at the end
    blocks = np.zeros((nnzb, tb, tb), np.float32)
    row_blocks = (uniq // nb).astype(np.int32)
    col_blocks = (uniq % nb).astype(np.int32)
    bounds = np.concatenate([starts, [E]])
    for k in range(nnzb):
        idx = order[bounds[k]:bounds[k + 1]]
        rr = receivers[idx] - row_blocks[k] * tb
        cc = senders[idx] - col_blocks[k] * tb
        np.add.at(blocks[k], (rr, cc), w[idx])
    if dtype != np.float32:
        import ml_dtypes  # numpy bfloat16 support

        blocks = blocks.astype(
            ml_dtypes.bfloat16 if dtype in ("bfloat16", jnp.bfloat16)
            else dtype)

    return BsrMatrix(
        blocks=jnp.asarray(blocks),
        col_blocks=jnp.asarray(col_blocks),
        row_blocks=jnp.asarray(row_blocks),
        num_row_blocks=nb, num_col_blocks=nb, tb=tb, num_nodes=num_nodes,
        density=nnzb / float(nb * nb),
    )


def bsr_spmm(bsr: BsrMatrix, x: jax.Array) -> jax.Array:
    """``out = A @ x`` over packed blocks. ``x``: (num_nodes, F) (padded
    internally to block multiple); returns (num_nodes, F)."""
    tb = bsr.tb
    n_pad = bsr.num_col_blocks * tb
    if x.shape[0] != n_pad:
        x = jnp.pad(x, ((0, n_pad - x.shape[0]), (0, 0)))
    xb = x.reshape(bsr.num_col_blocks, tb, x.shape[1])
    gathered = jnp.take(xb, bsr.col_blocks, axis=0)  # (nnzb, TB, F)
    # blocks stored bf16 pull the activations down to bf16 too, with f32
    # accumulation via preferred_element_type
    cdt = (jnp.bfloat16 if bsr.blocks.dtype == jnp.bfloat16 else x.dtype)
    prods = jnp.einsum("bij,bjf->bif", bsr.blocks.astype(cdt),
                       gathered.astype(cdt),
                       preferred_element_type=jnp.float32)
    out_b = jax.ops.segment_sum(
        prods, bsr.row_blocks, num_segments=bsr.num_row_blocks,
        indices_are_sorted=True)
    out = out_b.astype(x.dtype).reshape(bsr.num_row_blocks * tb, -1)
    return out[: bsr.num_nodes]


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True, eq=False)
class BandedMatrix:
    """Diagonal-band block storage: band ``d`` holds block ``(i, i+d)`` for
    every block-row ``i`` (zero where absent). One batched matmul per band,
    accumulated directly — no per-block product materialization (the BSR
    formulation's bottleneck)."""

    bands: jax.Array  # (n_bands, nb, TB, TB)
    offsets: tuple  # static band offsets d (col_block - row_block)
    nb: int
    tb: int
    num_nodes: int

    def tree_flatten(self):
        return ((self.bands,), (self.offsets, self.nb, self.tb,
                                self.num_nodes))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)


def build_banded(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    *,
    tb: int = 256,
    edge_weight: Optional[np.ndarray] = None,
    max_bands: int = 16,
    dtype=np.float32,
) -> Optional[BandedMatrix]:
    """Build diagonal-band storage; None if the graph needs more than
    ``max_bands`` distinct block-diagonals (not band-structured)."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    E = senders.shape[0]
    w = (np.ones(E, np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32).reshape(-1))
    nb = -(-num_nodes // tb)
    rb = receivers // tb
    cb = senders // tb
    offsets = np.unique(cb - rb)
    # refuse unstructured graphs: bands must be few AND a small fraction of
    # all possible diagonals (otherwise this is just a dense matrix)
    if len(offsets) > max_bands or len(offsets) >= max((2 * nb - 1) // 2, 2):
        return None
    k_of_edge = np.searchsorted(offsets, cb - rb)
    rloc = receivers - rb * tb
    cloc = senders - cb * tb
    flat = ((k_of_edge * nb + rb) * tb + rloc) * tb + cloc
    shape = (len(offsets), nb, tb, tb)
    jdtype = (jnp.bfloat16 if dtype in ("bfloat16", jnp.bfloat16)
              else jnp.dtype(dtype))
    host = np.zeros((int(np.prod(shape)),), np.float32)
    np.add.at(host, flat, w)
    bands = jnp.asarray(host.reshape(shape)).astype(jdtype)
    return BandedMatrix(bands=bands,
                        offsets=tuple(int(d) for d in offsets),
                        nb=nb, tb=tb, num_nodes=num_nodes)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True, eq=False)
class PackedBanded:
    """Row-packed block-band storage: block-row ``i`` holds its NONZERO
    blocks only, in slots ``s`` with absolute block-column ``cols[i, s]``
    (self-column padding on unused slots — the padded block is zero).

    After RCM an unstructured Delaunay mesh populates only a few of the
    block diagonals in each block-row, so packing by row stores far fewer
    zero blocks than ``BandedMatrix``."""

    blocks: jax.Array  # (S, nb_r, TB_R, TB_C) — slot-major, like bands
    cols: jax.Array  # (nb_r, S) int32 absolute block-COLUMN (pad: self)
    nb: int  # row-block count (ceil(n / tb_rows))
    tb: int  # block COLUMN width (x-fetch granularity)
    num_nodes: int
    # block ROW height; tall blocks (e.g. 512x128) keep the narrow column
    # granularity that makes packing sparse
    tb_rows: int = 0  # 0 = square (tb)

    @property
    def row_height(self) -> int:
        return self.tb_rows or self.tb

    @property
    def num_col_blocks(self) -> int:
        return -(-self.num_nodes // self.tb)

    def tree_flatten(self):
        return ((self.blocks, self.cols), (self.nb, self.tb,
                                           self.num_nodes, self.tb_rows))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], *aux)


def build_packed_banded(
    senders: np.ndarray,
    receivers: np.ndarray,
    num_nodes: int,
    *,
    tb: int = 128,
    tb_rows: Optional[int] = None,
    edge_weight: Optional[np.ndarray] = None,
    max_slots: int = 32,
    dtype=np.float32,
) -> Optional[PackedBanded]:
    """Row-packed block storage (``tb_rows`` x ``tb`` blocks; default
    square); None when some block-row needs more than ``max_slots`` nonzero
    blocks (not bandwidth-limited under this tb)."""
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    tbr = tb_rows or tb
    E = senders.shape[0]
    w = (np.ones(E, np.float32) if edge_weight is None
         else np.asarray(edge_weight, np.float32).reshape(-1))
    nb = -(-num_nodes // tbr)  # row blocks
    nbc = -(-num_nodes // tb)  # column blocks
    rb = receivers // tbr
    cb = senders // tb
    # unique (block-row, block-col) pairs -> slot ranks within the row
    key = rb * nbc + cb
    uniq, inv = np.unique(key, return_inverse=True)
    if len(uniq) == 0:
        return None
    u_r = uniq // nbc
    u_c = uniq % nbc
    first = np.concatenate([[0], np.flatnonzero(np.diff(u_r)) + 1])
    gid = np.searchsorted(first, np.arange(len(uniq)), side="right") - 1
    rank = np.arange(len(uniq)) - first[gid]
    per_row = np.diff(np.concatenate([first, [len(uniq)]]))
    S = int(per_row.max())
    if S > max_slots:
        return None
    # pad slots point at a block whose stored content is zero: clamp the
    # row's own column index into the column-block range
    own = np.minimum(np.arange(nb, dtype=np.int64) * (tbr // tb)
                     if tbr >= tb else np.arange(nb, dtype=np.int64),
                     nbc - 1)
    cols = np.tile(own[:, None], (1, S))
    cols[u_r, rank] = u_c
    slot_of_edge = rank[inv]
    rloc = receivers - rb * tbr
    cloc = senders - cb * tb
    flat = ((slot_of_edge * nb + rb) * tbr + rloc) * tb + cloc
    shape = (S, nb, tbr, tb)
    jdtype = (jnp.bfloat16 if dtype in ("bfloat16", jnp.bfloat16)
              else jnp.dtype(dtype))
    host = np.zeros((int(np.prod(shape)),), np.float32)
    np.add.at(host, flat, w)
    blocks = jnp.asarray(host.reshape(shape)).astype(jdtype)
    return PackedBanded(blocks=blocks, cols=jnp.asarray(cols, jnp.int32),
                        nb=nb, tb=tb, num_nodes=num_nodes, tb_rows=tbr)


def packed_banded_spmm(pb: PackedBanded, x: jax.Array) -> jax.Array:
    """XLA reference: ``out[i] = Σ_s blocks[s, i] @ x_block[cols[i, s]]``."""
    tb, nb, tbr = pb.tb, pb.nb, pb.row_height
    nbc = pb.num_col_blocks
    n_pad_c = nbc * tb
    if x.shape[0] != n_pad_c:
        x = jnp.pad(x, ((0, n_pad_c - x.shape[0]), (0, 0)))
    cdt = (jnp.bfloat16 if pb.blocks.dtype == jnp.bfloat16 else x.dtype)
    xb = x.astype(cdt).reshape(nbc, tb, x.shape[1])
    out = jnp.zeros((nb, tbr, x.shape[1]), jnp.float32)
    S = pb.blocks.shape[0]
    for s in range(S):
        gathered = jnp.take(xb, pb.cols[:, s], axis=0)
        out = out + jnp.einsum("bij,bjf->bif",
                               pb.blocks[s].astype(cdt), gathered,
                               preferred_element_type=jnp.float32)
    return out.astype(x.dtype).reshape(nb * tbr, -1)[: pb.num_nodes]


def transpose_packed_banded(senders, receivers, num_nodes, *, tb=128,
                            tb_rows=None, edge_weight=None, max_slots=32,
                            dtype=np.float32):
    """Packed storage of Aᵀ (for VJPs): just the reversed edge list."""
    return build_packed_banded(receivers, senders, num_nodes, tb=tb,
                               tb_rows=tb_rows, edge_weight=edge_weight,
                               max_slots=max_slots, dtype=dtype)


def banded_spmm(bm: BandedMatrix, x: jax.Array) -> jax.Array:
    """``out = A @ x`` via one batched matmul per diagonal band."""
    tb, nb = bm.tb, bm.nb
    n_pad = nb * tb
    if x.shape[0] != n_pad:
        x = jnp.pad(x, ((0, n_pad - x.shape[0]), (0, 0)))
    cdt = (jnp.bfloat16 if bm.bands.dtype == jnp.bfloat16 else x.dtype)
    xb = x.astype(cdt).reshape(nb, tb, x.shape[1])
    out = jnp.zeros((nb, tb, x.shape[1]), jnp.float32)
    for k, d in enumerate(bm.offsets):
        # x block column i+d for each row i, zero-padded at the boundary
        if d == 0:
            shifted = xb
        elif d > 0:
            shifted = jnp.concatenate(
                [xb[d:], jnp.zeros((d, tb, x.shape[1]), cdt)], axis=0)
        else:
            shifted = jnp.concatenate(
                [jnp.zeros((-d, tb, x.shape[1]), cdt), xb[:d]], axis=0)
        out = out + jnp.einsum("bij,bjf->bif",
                               bm.bands[k].astype(cdt), shifted,
                               preferred_element_type=jnp.float32)
    return out.astype(x.dtype).reshape(n_pad, -1)[: bm.num_nodes]
