from .scatter import (
    gather,
    segment_sum,
    segment_mean,
    segment_max,
    segment_min,
    segment_prod,
    segment_reduce,
    canonical_reduction,
)
from .message_passing import (
    propagate,
    apply_edges,
    aggregate_neighbors,
    copy_xi,
    copy_xj,
    xi_dot_xj,
    xi_sub_xj,
    xj_sub_xi,
    e_mul_xj,
    w_mul_xj,
    reduce_nodes,
    reduce_edges,
    broadcast_nodes,
    broadcast_edges,
    softmax_nodes,
    softmax_edges,
    softmax_edge_neighbors,
)
from .spmm import spmm, precompute, set_spmm_mode, get_spmm_mode
from .bsr import (BsrMatrix, BandedMatrix, build_bsr, bsr_spmm,
                  build_banded, banded_spmm)
from .dia import (DiaMatrix, build_dia, build_dia_hybrid,
                  dia_remainder_spmm, dia_spmm, transpose_dia)

__all__ = [
    "gather", "segment_sum", "segment_mean", "segment_max", "segment_min",
    "segment_prod", "segment_reduce", "canonical_reduction", "propagate",
    "apply_edges", "aggregate_neighbors", "copy_xi", "copy_xj", "xi_dot_xj",
    "xi_sub_xj", "xj_sub_xi", "e_mul_xj", "w_mul_xj", "reduce_nodes",
    "reduce_edges", "broadcast_nodes", "broadcast_edges", "softmax_nodes",
    "softmax_edges", "softmax_edge_neighbors", "spmm", "precompute",
    "set_spmm_mode", "get_spmm_mode", "BsrMatrix", "BandedMatrix",
    "build_bsr", "bsr_spmm", "build_banded", "banded_spmm",
    "DiaMatrix", "build_dia", "build_dia_hybrid", "dia_remainder_spmm",
    "dia_spmm", "transpose_dia",
]
