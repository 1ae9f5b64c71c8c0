"""Persistent XLA compilation cache for the scripts (``chip_smoke.py``,
``bench.py``, ``examples/``).

The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says when it is set
(JAX reads that variable itself); otherwise in ``.jax_cache/`` at the root
of the checkout, a fixed path so that a later run finds what an earlier one
compiled.
"""
from __future__ import annotations

import os

import jax

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
