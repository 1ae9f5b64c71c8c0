"""Config 2 (BASELINE.json): VMHConv neural graph ODE on 2D
convection-diffusion over scattered nodes — the reference's VMH tutorial
(docs/src/tutorials/VMH.md) as a runnable script, including the
graph-rebind-per-batch pattern (VMH.md:134) and the published loss curve as
the parity target (BASELINE.md: 0.0272 @ epoch 10 → 0.00098 @ epoch 200).

CPU-quick: python examples/train_vmh.py --cpu --sims 4 --points 300 --epochs 20
"""
import os as _os, sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import argparse
import dataclasses
import pickle
import time
import types

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass
class Config:
    num_sims: int = 24
    num_points: int = 3000
    t_end: float = 0.2
    num_saves: int = 21
    hidden: int = 60
    msg_dim: int = 40
    depth: int = 3
    # Reference optimizer config (VMH.md:97): Rprop(1e-6, (0.5, 1.2),
    # (1e-8, 10.0)) — initial step 1e-6, step_max 10. Rprop is a FULL-BATCH
    # method (sign-based); the reference trains with batchsize=24 = all sims
    # (VMH.md:120). Minibatching it stalls (plateaued at 0.030).
    optimizer: str = "rprop"
    lr: float = 1e-6
    step_max: float = 10.0
    epochs: int = 200
    batch: int = 24
    # gradient-accumulation microbatch: the full-batch gradient is summed
    # over ceil(batch/accum) microbatches of `accum` sims, which bounds the
    # adjoint's peak memory
    accum: int = 4
    seed: int = 0
    # Reference solves at reltol=1e-9 (VMH.md:87); 1e-5 keeps trajectory
    # error far below the 1e-3-scale MSE target at ~4x fewer solver steps.
    # abstol matches the reference.
    rtol: float = 1e-5
    atol: float = 1e-3
    # 'checkpoint' = the reference's InterpolatingAdjoint analog (stable on
    # the diffusive dynamics); 'backsolve' = classic continuous adjoint.
    adjoint: str = "checkpoint"
    # bounds accepted steps over the whole span (hermite replay); overflow
    # poisons gradients with NaN. 128 covers rtol=1e-5 stepping.
    checkpoint_steps: int = 128
    log_every: int = 10
    log_path: str = ""
    # pickle (ps, opt_state, epoch) here every ``ckpt_every`` epochs so a
    # killed run resumes instead of losing hours (Rprop state included —
    # its per-leaf step sizes ARE the optimizer's memory)
    ckpt_path: str = ""
    ckpt_every: int = 5
    # Adaptive-solve attempt bound PER INTERVAL: a pathologically stiff
    # solve (late-training params can sharpen one trajectory) is truncated
    # instead of spinning; that epoch's gradient goes noisy-but-finite and
    # training continues.
    max_steps: int = 10_000


def setup(cfg: Config, data=None):
    """Model, parameters, optimizer and the jitted epoch pieces of the
    reference protocol. ``data`` (a ``ConvectionDiffusionData``) is
    generated from ``cfg`` when not given. The aggregation path is chosen
    when the jitted functions first trace (``ops.set_spmm_mode``)."""
    import optax

    from neuralgraphpde import precompute, setup as setup_layer, update_graph
    from neuralgraphpde.data.pde import convection_diffusion_dataset
    from neuralgraphpde.models import vmh_model
    from neuralgraphpde.train import adam, rprop

    if data is None:
        data = convection_diffusion_dataset(
            num_sims=cfg.num_sims, num_points=cfg.num_points,
            t_end=cfg.t_end, num_saves=cfg.num_saves, seed=cfg.seed)

    saveat = tuple(np.asarray(data.ts))
    model = vmh_model(1, 2, hidden=cfg.hidden, msg_dim=cfg.msg_dim,
                      depth=cfg.depth, tspan=(saveat[0], saveat[-1]),
                      saveat=saveat, rtol=cfg.rtol, atol=cfg.atol,
                      adjoint=cfg.adjoint,
                      checkpoint_steps=cfg.checkpoint_steps,
                      max_steps=cfg.max_steps)
    ps, st = setup_layer(jax.random.PRNGKey(cfg.seed), model)
    # all sims share one graph: bind it once (re-bind per batch when graphs
    # differ — the update_graph pattern). precompute sorts the edges by
    # receiver and caches degrees for the solver hot loop.
    st = update_graph(st, precompute(data.graph, dense=False))

    # ``u`` and ``st`` are jit ARGUMENTS, not closure captures: captured
    # arrays would be embedded in the program as constants.
    def loss_fn(ps, u_batch, st):
        def one(u_traj):
            pred, _ = model(u_traj[0], ps, st)
            return jnp.mean((pred - u_traj) ** 2)

        return jnp.mean(jax.vmap(one)(u_batch))

    opt = (rprop(cfg.lr, step_max=cfg.step_max)
           if cfg.optimizer == "rprop" else adam(cfg.lr))

    # Full-batch Rprop (the reference trains with batchsize = all 24 sims,
    # VMH.md:120) via on-device gradient ACCUMULATION over equal microbatches
    # (one compiled shape), then one apply step.
    mb = max(min(cfg.accum, cfg.batch), 1)
    while cfg.num_sims % mb:
        mb -= 1
    n_micro = cfg.num_sims // mb

    @jax.jit
    def micro_grad(ps, acc, u_mb, st):
        loss, grads = jax.value_and_grad(loss_fn)(ps, u_mb, st)
        return jax.tree_util.tree_map(jnp.add, acc, grads), loss

    @jax.jit
    def apply_step(ps, opt_state, acc):
        grads = jax.tree_util.tree_map(lambda g: g / n_micro, acc)
        updates, opt_state = opt.update(grads, opt_state, ps)
        return optax.apply_updates(ps, updates), opt_state

    return types.SimpleNamespace(
        cfg=cfg, data=data, model=model, ps=ps, st=st,
        u=jnp.asarray(data.u), opt=opt, opt_state=opt.init(ps), mb=mb,
        n_micro=n_micro, micro_grad=micro_grad, apply_step=apply_step)


def epoch_gradient(tr, ps):
    """Full-batch ``(mse, summed gradient)`` of one epoch at ``ps``."""
    acc = jax.tree_util.tree_map(jnp.zeros_like, ps)
    losses = []
    for i in range(tr.n_micro):
        acc, loss = tr.micro_grad(ps, acc, tr.u[i * tr.mb:(i + 1) * tr.mb],
                                  tr.st)
        losses.append(loss)
    return jnp.mean(jnp.stack(losses)), acc


def main(cfg: Config):
    from neuralgraphpde.train import MetricsLogger

    tr = setup(cfg)
    ps, opt_state = tr.ps, tr.opt_state
    logger = MetricsLogger(path=cfg.log_path or None)

    # structure-affecting config (a mismatch would silently map saved leaves
    # onto a different model/optimizer tree); NB pickle is only safe for
    # files this run (or a trusted peer) wrote — don't point --ckpt-path at
    # untrusted data
    arch_cfg = {k: getattr(cfg, k) for k in
                ("num_sims", "num_points", "hidden", "msg_dim", "depth",
                 "optimizer")}
    start_epoch = 1
    if cfg.ckpt_path and _os.path.exists(cfg.ckpt_path):
        with open(cfg.ckpt_path, "rb") as f:
            saved = pickle.load(f)
        if saved.get("arch_cfg", arch_cfg) != arch_cfg:
            raise ValueError(
                f"checkpoint {cfg.ckpt_path} was written with a different "
                f"architecture config: {saved['arch_cfg']} vs {arch_cfg}")
        want_def = jax.tree_util.tree_structure(ps)
        got_def = jax.tree_util.tree_structure(saved["ps"])
        if want_def != got_def:
            raise ValueError(
                f"checkpoint param tree mismatch: {got_def} vs {want_def}")
        ps = jax.tree_util.tree_map(jnp.asarray, saved["ps"])
        opt_state = jax.tree_util.tree_map(
            lambda ref, v: jnp.asarray(v) if hasattr(ref, "dtype") else v,
            opt_state, saved["opt_state"])
        start_epoch = saved["epoch"] + 1
        print(f"resumed from {cfg.ckpt_path} at epoch {saved['epoch']}",
              flush=True)

    def _save_ckpt(epoch):
        if not cfg.ckpt_path:
            return
        blob = {"ps": jax.device_get(ps),
                "opt_state": jax.device_get(opt_state), "epoch": epoch,
                "arch_cfg": arch_cfg}
        tmp = cfg.ckpt_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(blob, f)
        _os.replace(tmp, cfg.ckpt_path)

    t0 = time.time()
    for epoch in range(start_epoch, cfg.epochs + 1):
        loss, acc = epoch_gradient(tr, ps)
        ps, opt_state = tr.apply_step(ps, opt_state, acc)
        mse = float(loss)  # device sync
        if epoch % cfg.log_every == 0 or epoch == cfg.epochs:
            rec = logger.log(epoch, train_mse=mse)
            print(f"epoch {epoch:4d} | train mse {rec['train_mse']:.5f} "
                  f"| {time.time()-t0:.0f}s", flush=True)
        if cfg.ckpt_every and epoch % cfg.ckpt_every == 0:
            _save_ckpt(epoch)
    _save_ckpt(cfg.epochs)
    return logger


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--sims", type=int, default=24)
    p.add_argument("--points", type=int, default=3000)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--optimizer", default="rprop")
    p.add_argument("--adjoint", default="checkpoint")
    p.add_argument("--log-path", default="")
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--ckpt-steps", type=int, default=128)
    p.add_argument("--rtol", type=float, default=1e-5)
    p.add_argument("--atol", type=float, default=1e-3)
    p.add_argument("--accum", type=int, default=4)
    p.add_argument("--ckpt-path", default="")
    p.add_argument("--max-steps", type=int, default=10_000)
    args = p.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from neuralgraphpde.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main(Config(num_sims=args.sims, num_points=args.points,
                epochs=args.epochs, optimizer=args.optimizer,
                adjoint=args.adjoint, log_path=args.log_path,
                log_every=args.log_every, checkpoint_steps=args.ckpt_steps,
                rtol=args.rtol, atol=args.atol, accum=args.accum,
                ckpt_path=args.ckpt_path, max_steps=args.max_steps))
