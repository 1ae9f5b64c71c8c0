"""Config 1 (BASELINE.json): GRAND-style graph neural diffusion on a
Cora-shaped citation graph — the reference's first tutorial
(docs/src/tutorials/graph_node.md) as a runnable script.

CPU-runnable: python examples/train_grand_cora.py --cpu --epochs 20
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import argparse
import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass
class Config:
    num_nodes: int = 2708
    num_edges: int = 10556
    num_features: int = 1433
    num_classes: int = 7
    hidden: int = 64
    tspan_end: float = 1.0
    solver: str = "dopri5"
    rtol: float = 1e-3
    atol: float = 1e-3
    lr: float = 1e-2
    epochs: int = 100
    seed: int = 0
    data_path: str = ""  # LINQS cora.content/cora.cites dir; synthetic if empty


def main(cfg: Config):
    from neuralgraphpde import add_self_loops, precompute, setup, update_graph
    from neuralgraphpde.data import cora_dataset
    from neuralgraphpde.models import grand_model
    from neuralgraphpde.train import (
        MetricsLogger, accuracy, adam, make_train_step, masked_cross_entropy,
    )

    data = cora_dataset(cfg.data_path or None, num_nodes=cfg.num_nodes,
                        num_edges=cfg.num_edges,
                        num_features=cfg.num_features,
                        num_classes=cfg.num_classes, seed=cfg.seed)
    if cfg.data_path:
        cfg.num_features = data.features.shape[1]
        cfg.num_classes = data.num_classes
    g = precompute(add_self_loops(data.graph))

    model = grand_model(cfg.num_features, cfg.hidden, cfg.num_classes,
                        tspan=(0.0, cfg.tspan_end), solver=cfg.solver,
                        rtol=cfg.rtol, atol=cfg.atol,
                        precomputed_self_loops=True)
    ps, st = setup(jax.random.PRNGKey(cfg.seed), model)
    st = update_graph(st, g)

    x = jnp.asarray(data.features)
    y = jnp.asarray(data.labels)
    train_m = jnp.asarray(data.train_mask)
    val_m = jnp.asarray(data.val_mask)

    def loss_fn(ps):
        logits, _ = model(x, ps, st)
        return masked_cross_entropy(logits, y, train_m)

    @jax.jit
    def evaluate(ps):
        logits, _ = model(x, ps, st)
        return (accuracy(logits, y, train_m), accuracy(logits, y, val_m))

    opt = adam(cfg.lr)
    opt_state = opt.init(ps)
    step = make_train_step(lambda ps: loss_fn(ps), opt, donate=False)
    logger = MetricsLogger()
    for epoch in range(cfg.epochs):
        ps, opt_state, loss, _ = step(ps, opt_state)
        if (epoch + 1) % 10 == 0 or epoch == 0:
            tr_acc, va_acc = evaluate(ps)
            rec = logger.log(epoch + 1, loss=loss, train_acc=tr_acc,
                             val_acc=va_acc)
            print(f"epoch {epoch + 1:4d} | loss {rec['loss']:.4f} | "
                  f"train acc {rec['train_acc']:.3f} | "
                  f"val acc {rec['val_acc']:.3f}")
    return logger


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--nodes", type=int, default=2708)
    p.add_argument("--features", type=int, default=1433)
    p.add_argument("--data-path", default="",
                   help="directory with cora.content/cora.cites (real data)")
    args = p.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from neuralgraphpde.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main(Config(epochs=args.epochs, num_nodes=args.nodes,
                num_edges=args.nodes * 4, num_features=args.features,
                data_path=args.data_path))
