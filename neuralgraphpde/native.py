"""ctypes bindings for the native graph-preprocessing runtime (csrc/).

Builds ``csrc/libngpde_graph.so`` on first use (g++ is in the base image)
and falls back to pure NumPy when the toolchain is unavailable. Every entry
point has a NumPy reference implementation; parity is tested in
tests/test_native.py.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "csrc")
_LIB_PATH = os.path.join(_CSRC, "libngpde_graph.so")
_LIB = None
_TRIED = False

_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", _CSRC], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    lib.ngp_sort_by_receiver.restype = ctypes.c_int
    lib.ngp_sort_by_receiver.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _i32p, _i64p]
    lib.ngp_csr_offsets.restype = ctypes.c_int
    lib.ngp_csr_offsets.argtypes = [ctypes.c_int64, ctypes.c_int64, _i32p,
                                    _i64p]
    lib.ngp_greedy_partition.restype = ctypes.c_int
    lib.ngp_greedy_partition.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _i32p, ctypes.c_int64, _i32p]
    lib.ngp_radius_graph_2d_count.restype = ctypes.c_int64
    lib.ngp_radius_graph_2d_count.argtypes = [ctypes.c_int64, _f32p,
                                              ctypes.c_float]
    lib.ngp_radius_graph_2d_build.restype = ctypes.c_int
    lib.ngp_radius_graph_2d_build.argtypes = [
        ctypes.c_int64, _f32p, ctypes.c_float, _i32p, _i32p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def sort_by_receiver(receivers: np.ndarray, num_nodes: int) -> np.ndarray:
    """Stable receiver-sort permutation (counting sort in C++)."""
    receivers = np.ascontiguousarray(receivers, np.int32)
    lib = _load()
    if lib is None:
        return np.argsort(receivers, kind="stable").astype(np.int64)
    perm = np.empty(receivers.shape[0], np.int64)
    rc = lib.ngp_sort_by_receiver(receivers.shape[0], num_nodes, receivers,
                                  perm)
    if rc != 0:
        raise ValueError("receiver index out of range")
    return perm


def csr_offsets(sorted_receivers: np.ndarray, num_nodes: int) -> np.ndarray:
    sorted_receivers = np.ascontiguousarray(sorted_receivers, np.int32)
    lib = _load()
    if lib is None:
        counts = np.bincount(sorted_receivers, minlength=num_nodes)
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    out = np.empty(num_nodes + 1, np.int64)
    rc = lib.ngp_csr_offsets(sorted_receivers.shape[0], num_nodes,
                             sorted_receivers, out)
    if rc != 0:
        raise ValueError("receiver index out of range")
    return out


def greedy_partition(receivers: np.ndarray, num_nodes: int,
                     num_parts: int) -> np.ndarray:
    """Degree-balanced greedy node partition (C++), NumPy fallback is a
    simple contiguous split."""
    receivers = np.ascontiguousarray(receivers, np.int32)
    lib = _load()
    if lib is None:
        npp = -(-num_nodes // num_parts)
        return (np.arange(num_nodes) // npp).astype(np.int32)
    out = np.empty(num_nodes, np.int32)
    lib.ngp_greedy_partition(receivers.shape[0], num_nodes, receivers,
                             num_parts, out)
    return out


def radius_graph_2d(points: np.ndarray,
                    radius: float) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Cell-list 2D radius graph; None -> caller falls back to scipy."""
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, np.float32)
    n = pts.shape[0]
    E = int(lib.ngp_radius_graph_2d_count(n, pts, radius))
    s = np.empty(E, np.int32)
    r = np.empty(E, np.int32)
    lib.ngp_radius_graph_2d_build(n, pts, radius, s, r)
    return s, r
