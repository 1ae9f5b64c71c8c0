"""Config 4 (BASELINE.json): GNOConv graph kernel network on Darcy flow
(radius graph, edge-weighted kernel integration).

CPU-quick: python examples/train_gno_darcy.py --cpu --samples 8 --n 16 --epochs 20
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
    num_samples: int = 32
    n: int = 32  # grid resolution (n^2 nodes)
    radius: float = 0.08
    width: int = 64
    ker_width: int = 128
    depth: int = 4
    lr: float = 1e-3
    epochs: int = 50
    seed: int = 0
    log_path: str = ""


def main(cfg: Config):
    from neuralgraphpde import precompute, setup, update_graph
    from neuralgraphpde.data.pde import darcy_dataset
    from neuralgraphpde.models import GNOModel
    from neuralgraphpde.train import MetricsLogger, adam, make_train_step

    # keep the radius graph connected at coarse resolutions
    radius = max(cfg.radius, 1.6 / (cfg.n + 1))
    data = darcy_dataset(num_samples=cfg.num_samples, n=cfg.n,
                         radius=radius, seed=cfg.seed)
    model = GNOModel(a_dim=1, pos_dim=2, width=cfg.width,
                     ker_width=cfg.ker_width, depth=cfg.depth,
                     initialgraph=data.graph)
    ps, st = setup(jax.random.PRNGKey(cfg.seed), model)
    st = update_graph(st, precompute(data.graph, dense=False))

    a_scale = float(np.abs(data.a).max())
    u_scale = float(np.abs(data.u).max())
    a = jnp.asarray(data.a) / a_scale
    u = jnp.asarray(data.u) / u_scale
    n_train = max(cfg.num_samples * 3 // 4, 1)

    def loss_fn(ps, a_b, u_b):
        def one(ai, ui):
            pred, _ = model(ai, ps, st)
            return jnp.mean((pred - ui) ** 2)

        return jnp.mean(jax.vmap(one)(a_b, u_b))

    opt = adam(cfg.lr)
    opt_state = opt.init(ps)
    step = make_train_step(loss_fn, opt, donate=False)
    logger = MetricsLogger(path=cfg.log_path or None)
    rng = np.random.default_rng(cfg.seed)
    batch = 4
    for epoch in range(cfg.epochs):
        perm = rng.permutation(n_train)
        for i in range(0, n_train, batch):
            idx = perm[i:i + batch]
            ps, opt_state, loss, _ = step(ps, opt_state, a[idx], u[idx])
        if (epoch + 1) % 5 == 0 or epoch == 0:
            test_mse = float(loss_fn(ps, a[n_train:], u[n_train:])) \
                if cfg.num_samples > n_train else float("nan")
            rec = logger.log(epoch + 1, train_mse=loss, test_mse=test_mse)
            print(f"epoch {epoch + 1:3d} | train mse {rec['train_mse']:.5f} "
                  f"| test mse {rec['test_mse']:.5f}")
    return logger


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--samples", type=int, default=32)
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--log-path", type=str, default="")
    args = p.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from neuralgraphpde.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main(Config(num_samples=args.samples, n=args.n, epochs=args.epochs,
                log_path=args.log_path))
