"""Smoke-run the benchmark-config example scripts with tiny sizes
(subprocess, CPU) — the executable-docs role of the reference's doctested
tutorials (SURVEY §4)."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_example(args, timeout=150):
    env = dict(os.environ)
    proc = subprocess.run(
        [sys.executable] + args, cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


@pytest.mark.slow
def test_grand_cora_example():
    out = run_example(["examples/train_grand_cora.py", "--cpu",
                       "--epochs", "5", "--nodes", "200", "--features", "32"])
    assert "epoch" in out


@pytest.mark.slow
def test_gno_darcy_example():
    out = run_example(["examples/train_gno_darcy.py", "--cpu",
                       "--samples", "2", "--n", "8", "--epochs", "2"])
    assert "train mse" in out


@pytest.mark.slow
def test_distributed_example():
    out = run_example(["examples/distributed_grand.py", "--cpu8",
                       "--nodes", "2000", "--degree", "6"])
    assert "steady step" in out


def test_spectral_conv_float64_accuracy():
    """Reproduce the reference docstring's f64 accuracy (~1e-13 per point,
    reference src/layers.jl:590-631) — x64 needs its own process."""
    code = """
import jax
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)
import jax.numpy as jnp
from neuralgraphpde import SpectralConv, setup
l = SpectralConv(100)
ps, st = setup(jax.random.PRNGKey(0), l)
x = jnp.linspace(0, 2 * jnp.pi, 101, dtype=jnp.float64)[1:]
dy, _ = l(jnp.sin(x), ps, st)
err = float(jnp.max(jnp.abs(dy - jnp.cos(x))))
assert err < 1e-10, err
print('max f64 error:', err)
"""
    out = run_example(["-c", code])
    assert "max f64 error" in out


@pytest.mark.slow
def test_scale_products_pipeline_small():
    """Config-5 scale pipeline (examples/scale_products.py) end to end at a
    reduced size: COO generation and a 4-way halo partition. The full-size
    run (124M edges) is gated behind NGPDE_SCALE=1."""
    out = run_example(["examples/scale_products.py", "--cpu",
                       "--nodes", "20000", "--edges", "200000",
                       "--parts", "4", "--stage", "build,partition"],
                      timeout=300)
    assert "partition" in out


@pytest.mark.slow
@pytest.mark.skipif(not os.environ.get("NGPDE_SCALE"),
                    reason="full 124M-edge scale run (~10 min, ~17 GB RSS); "
                           "set NGPDE_SCALE=1")
def test_scale_products_full():
    out = run_example(["examples/scale_products.py", "--cpu",
                       "--stage", "build,partition"], timeout=1800)
    assert "partition" in out
