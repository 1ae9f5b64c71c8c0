"""Model-zoo smoke + learning tests on small synthetic data (CPU)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from neuralgraphpde import setup, update_graph
from neuralgraphpde.data.pde import (
    burgers_dataset, convection_diffusion_dataset, darcy_dataset,
)
from neuralgraphpde.data.synthetic import synthetic_cora
from neuralgraphpde.models import GNOModel, MPPDESolver, grand_model, vmh_model
from neuralgraphpde.train import masked_cross_entropy, accuracy, make_train_step


@pytest.mark.slow
def test_grand_learns_synthetic_cora():
    data = synthetic_cora(num_nodes=200, num_edges=1600, num_features=32,
                          num_classes=4, seed=0)
    model = grand_model(32, 32, 4, tspan=(0.0, 1.0), rtol=1e-2, atol=1e-2)
    ps, st = setup(jax.random.PRNGKey(0), model)
    st = update_graph(st, data.graph)
    x = jnp.asarray(data.features)
    y = jnp.asarray(data.labels)
    tm = jnp.asarray(data.train_mask)

    def loss_fn(ps):
        logits, _ = model(x, ps, st)
        return masked_cross_entropy(logits, y, tm)

    opt = optax.adam(5e-3)
    step = make_train_step(lambda ps: loss_fn(ps), opt, donate=False)
    opt_state = opt.init(ps)
    l0 = float(loss_fn(ps))
    for _ in range(30):
        ps, opt_state, loss, _ = step(ps, opt_state)
    l1 = float(loss)
    assert l1 < l0 * 0.7, f"loss did not decrease: {l0} -> {l1}"
    logits, _ = model(x, ps, st)
    acc = float(accuracy(logits, y, tm))
    assert acc > 0.5


@pytest.mark.slow
def test_vmh_rollout_trains():
    data = convection_diffusion_dataset(num_sims=2, num_points=80, grid_n=32,
                                        num_saves=5, seed=0)
    saveat = tuple(np.asarray(data.ts))
    model = vmh_model(1, 2, hidden=16, msg_dim=8, depth=2,
                      tspan=(float(data.ts[0]), float(data.ts[-1])),
                      saveat=saveat, rtol=1e-2, atol=1e-2)
    ps, st = setup(jax.random.PRNGKey(0), model)
    st = update_graph(st, data.graph)

    u = jnp.asarray(data.u[0])  # (T, M, 1)
    u0 = u[0]

    def loss_fn(ps):
        traj, _ = model(u0, ps, st)
        return jnp.mean((traj - u) ** 2)

    l0 = float(loss_fn(ps))
    opt = optax.adam(1e-2)
    opt_state = opt.init(ps)
    step = make_train_step(lambda ps: loss_fn(ps), opt, donate=False)
    for _ in range(10):
        ps, opt_state, loss, _ = step(ps, opt_state)
    assert float(loss) < l0
    assert np.isfinite(float(loss))


def test_mppde_bundled_rollout():
    data = burgers_dataset(num_sims=2, nx=32, num_saves=17, seed=0,
                           substeps=10)
    K = 4
    model = MPPDESolver(bundle=K, hidden=16, depth=2, pos_dim=1,
                        initialgraph=data.graph)
    ps, st = setup(jax.random.PRNGKey(0), model)

    u = data.u[0, :, :, 0].T  # (nx, T)
    u_window = jnp.asarray(u[:, :K])
    target = jnp.asarray(u[:, K:2 * K])

    y, st2 = model(u_window, ps, st)
    assert y.shape == u_window.shape

    def loss_fn(ps):
        y, _ = model(u_window, ps, st)
        return jnp.mean((y - target) ** 2)

    l0 = float(loss_fn(ps))
    opt = optax.adam(1e-3)
    opt_state = opt.init(ps)
    step = make_train_step(lambda ps: loss_fn(ps), opt, donate=False)
    for _ in range(15):
        ps, opt_state, loss, _ = step(ps, opt_state)
    assert float(loss) < l0

    # K-step rollout via scan
    traj, _ = model.rollout(u_window, ps, st, num_bundles=3)
    assert traj.shape == (3,) + u_window.shape


def test_gno_darcy_trains():
    data = darcy_dataset(num_samples=2, n=8, radius=0.3, seed=0)
    model = GNOModel(a_dim=1, pos_dim=2, width=8, ker_width=16, depth=2,
                     initialgraph=data.graph)
    ps, st = setup(jax.random.PRNGKey(0), model)

    a = jnp.asarray(data.a[0])
    u = jnp.asarray(data.u[0])
    u_scale = float(np.abs(data.u).max())

    def loss_fn(ps):
        pred, _ = model(a, ps, st)
        return jnp.mean((pred - u / u_scale) ** 2)

    l0 = float(loss_fn(ps))
    opt = optax.adam(1e-3)
    opt_state = opt.init(ps)
    step = make_train_step(lambda ps: loss_fn(ps), opt, donate=False)
    for _ in range(15):
        ps, opt_state, loss, _ = step(ps, opt_state)
    assert float(loss) < l0


def test_dataset_generators_shapes():
    d = convection_diffusion_dataset(num_sims=1, num_points=50, grid_n=16,
                                     num_saves=3)
    assert d.u.shape == (1, 3, 50, 1)
    assert d.graph.num_nodes == 50
    b = burgers_dataset(num_sims=1, nx=16, num_saves=3, substeps=5)
    assert b.u.shape == (1, 3, 16, 1)
    dd = darcy_dataset(num_samples=1, n=6, radius=0.4)
    assert dd.u.shape == (1, 36, 1)
    assert np.all(np.isfinite(dd.u))


@pytest.mark.skipif(not os.environ.get("NGPDE_SLOW"),
                    reason="full VMH parity run (~hours on CPU); set "
                           "NGPDE_SLOW=1. The recorded 200-epoch curve is in "
                           "PARITY.md")
def test_vmh_full_parity_curve():
    """Full reference VMH protocol (24 sims x 3000 Delaunay points, Rprop,
    200 epochs — reference docs/src/tutorials/VMH.md:53-148) on this repo's
    synthetic convection-diffusion stand-in (the reference's
    convdiff_n3000.jld2 needs a network download). Pins the recorded
    outcome: 0.0801 -> 0.0318 train MSE (PARITY.md).
    The reference's absolute 200-epoch value (0.00098, on ITS dataset)
    is the target once the real dataset can be mounted — see PARITY.md
    "VMH parity curve" for the honest comparison."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "train_vmh", os.path.join(os.path.dirname(__file__), "..",
                                  "examples", "train_vmh.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    logger = mod.main(mod.Config(num_sims=24, num_points=3000, epochs=200))
    final = logger.history[-1]["train_mse"]
    first = logger.history[0]["train_mse"]
    assert final <= 0.04, f"final train MSE {final} vs recorded 0.0318"
    assert final <= 0.5 * first, "must at least halve the initial MSE"
