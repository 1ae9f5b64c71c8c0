"""Tracing / profiling hooks (SURVEY §5.1): jax.profiler traces around
RHS/solver sections and a roofline-style throughput report for SpMM."""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import jax


@contextlib.contextmanager
def trace(dirname: str):
    """Capture a Perfetto/XPlane trace of the enclosed block."""
    jax.profiler.start_trace(dirname)
    try:
        yield dirname
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named profiler span (shows up in the trace timeline)."""
    return jax.profiler.TraceAnnotation(name)


def benchmark_fn(fn: Callable, *args, iters: int = 10,
                 warmup: int = 2) -> Dict[str, float]:
    """Wall-time a jitted callable (blocking on outputs)."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    return {"mean_s": dt, "per_s": 1.0 / dt}


# Published peaks per device, keyed by ``jax.Device.device_kind``. Source:
# NVIDIA H200 data sheet (SXM part, dense rates without sparsity, at the
# full 700 W power limit). A card set to a lower power limit cannot hold
# these rates; report the limit beside every share computed from them.
PEAKS = {
    "NVIDIA H200": {"hbm_bytes_per_s": 4.8e12, "bf16_flops": 989e12,
                    "tf32_flops": 495e12, "f32_flops": 67e12},
}


def device_peaks(device_kind: str) -> Dict[str, float]:
    """Peak rates for ``device_kind``; an unknown device is an error, not a
    default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind "
                       f"{device_kind!r}; add them to PEAKS with their "
                       f"source") from None


def spmm_roofline(num_edges: int, feature_dim: int, seconds: float,
                  device_kind: str,
                  dtype_bytes: int = 4) -> Dict[str, float]:
    """Edges/s against the HBM-bandwidth bound for gather + scatter SpMM.

    Lower-bound traffic per edge ≈ read + write of one feature row (ignoring
    cache reuse): ``2 · F · dtype_bytes``, at the device's peak HBM rate.
    """
    eps = num_edges / seconds
    bytes_per_edge = 2 * feature_dim * dtype_bytes
    sol_eps = device_peaks(device_kind)["hbm_bytes_per_s"] / bytes_per_edge
    return {
        "edges_per_s": eps,
        "speed_of_light_edges_per_s": sol_eps,
        "fraction_of_sol": eps / sol_eps,
    }
