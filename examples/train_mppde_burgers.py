"""Config 3 (BASELINE.json): MP-PDE solver on 1D Burgers rollouts with
temporal bundling (Brandstetter et al.) and the pushforward trick.

CPU-quick: python examples/train_mppde_burgers.py --cpu --sims 4 --nx 64 --epochs 10
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class Config:
    num_sims: int = 32
    nx: int = 256
    t_end: float = 2.0
    num_saves: int = 101
    bundle: int = 25
    hidden: int = 128
    depth: int = 6
    lr: float = 1e-4
    epochs: int = 20
    pushforward: bool = True
    seed: int = 0
    log_path: str = ""


def main(cfg: Config):
    from neuralgraphpde import precompute, setup
    from neuralgraphpde.data.pde import burgers_dataset
    from neuralgraphpde.models import MPPDESolver
    from neuralgraphpde.train import MetricsLogger, adam, make_train_step

    data = burgers_dataset(num_sims=cfg.num_sims, nx=cfg.nx, t_end=cfg.t_end,
                           num_saves=cfg.num_saves, seed=cfg.seed)
    K = cfg.bundle
    T = data.u.shape[1]
    assert T >= 3 * K, "need at least 3 bundles of snapshots"

    # precompute sorts the edges by receiver, which lets every MPPDEConv
    # take the fused ϕ-then-sum path (graph copies inside the model keep the
    # cache alive)
    g = precompute(data.graph, dense=False)
    model = MPPDESolver(bundle=K, hidden=cfg.hidden, depth=cfg.depth,
                        pos_dim=1, initialgraph=g)
    ps, st = setup(jax.random.PRNGKey(cfg.seed), model)

    # windows: (S, nx, T) -> samples of (u_window, u_next, u_next2)
    u = jnp.asarray(np.transpose(data.u[..., 0], (0, 2, 1)))  # (S, nx, T)

    starts = np.arange(0, T - 3 * K + 1, K)

    def sample(u_sim, s0):
        return (jax.lax.dynamic_slice_in_dim(u_sim, s0, K, axis=1),
                jax.lax.dynamic_slice_in_dim(u_sim, s0 + K, K, axis=1),
                jax.lax.dynamic_slice_in_dim(u_sim, s0 + 2 * K, K, axis=1))

    def loss_fn(ps, u_batch, s0s):
        def one(u_sim, s0):
            w0, w1, w2 = sample(u_sim, s0)
            pred1, _ = model(w0, ps, st)
            l1 = jnp.mean((pred1 - w1) ** 2)
            if cfg.pushforward:
                # pushforward trick: 2-step unroll, gradient only through
                # the second step
                pred2, _ = model(jax.lax.stop_gradient(pred1), ps, st)
                return l1 + jnp.mean((pred2 - w2) ** 2)
            return l1

        return jnp.mean(jax.vmap(one)(u_batch, s0s))

    opt = adam(cfg.lr)
    opt_state = opt.init(ps)
    step = make_train_step(loss_fn, opt, donate=False)
    logger = MetricsLogger(path=cfg.log_path or None)
    rng = np.random.default_rng(cfg.seed)
    for epoch in range(cfg.epochs):
        for i in range(cfg.num_sims):
            s0s = jnp.asarray(rng.choice(starts, size=4))
            u_batch = jnp.broadcast_to(u[i], (4,) + u[i].shape)
            ps, opt_state, loss, _ = step(ps, opt_state, u_batch, s0s)
        rec = logger.log(epoch + 1, train_mse=loss)
        print(f"epoch {epoch + 1:3d} | bundle mse {rec['train_mse']:.5f}")

    # rollout evaluation on the first sim
    w0 = u[0, :, :K]
    traj, _ = model.rollout(w0, ps, st, num_bundles=(T - K) // K)
    pred = jnp.concatenate([w0[None]] + [traj[i][None] for i in
                                         range(traj.shape[0])], axis=0)
    true = jnp.stack([u[0][:, k * K:(k + 1) * K]
                      for k in range(T // K)], axis=0)
    n = min(pred.shape[0], true.shape[0])
    rmse = float(jnp.sqrt(jnp.mean((pred[:n] - true[:n]) ** 2)))
    print(f"rollout rmse over {n * K} steps: {rmse:.4f}")
    if cfg.log_path:
        logger.log(cfg.epochs + 1, rollout_rmse=rmse)
    return logger


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--sims", type=int, default=32)
    p.add_argument("--nx", type=int, default=256)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--bundle", type=int, default=25)
    p.add_argument("--log-path", type=str, default="")
    args = p.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from neuralgraphpde.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main(Config(num_sims=args.sims, nx=args.nx, epochs=args.epochs,
                bundle=args.bundle, log_path=args.log_path))
