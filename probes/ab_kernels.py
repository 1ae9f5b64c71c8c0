#!/usr/bin/env python3
"""A/B of two hand-written Pallas kernels (Triton route) against what XLA
compiles from the plain JAX version, on one NVIDIA GPU.

    python probes/ab_kernels.py            # on the card: correctness + timings
    python probes/ab_kernels.py --check    # on the CPU: both kernels in
                                           # interpret mode, tiny shapes

The candidates (neither is used by the package; both lost, see PERF.md):

- ``dia_gcn_rhs``: the GCN ODE right-hand side on a stencil graph,
  ``tanh((Â x) W + b)`` with ``Â = D^-1/2 A D^-1/2`` stored as scalar
  diagonals. One program per block of ``bm`` rows: the K shifted row blocks
  of ``x`` are read as contiguous slices of a zero-padded copy, weighted and
  summed in registers (f32), then ``pl.dot`` with ``W``, bias and tanh, so
  the ``N×F`` stencil result never reaches device memory. The gradient is
  XLA's (stencil and its transpose, ``ops.dia``).
- ``edge_mlp``: the fused ϕ-then-sum of VMHConv / MPPDEConv (``nn.conv.
  edge_mlp_sum``): ϕ's tanh layers on each edge and the sum over receivers.
  One program per block of 32 receivers walks its receiver-sorted edges in
  chunks of 64, runs the layers with ``pl.dot`` and reduces each chunk with
  a one-hot product, so the ``E×60`` activations never reach device memory
  and no atomics are needed. Widths are zero-padded to powers of two
  (4 → 16, 60 → 64). The gradient is XLA's autodiff of the plain version.

What is timed (host clock around ``block_until_ready``; median of
``REPEATS`` after a warm-up, min and max beside it):

- ``dia/*``: 512×512 8-neighbour grid with self-loops (2,353,156 edges),
  F=128. ``rhs_xla_<dtype>``: one ``GCNConv`` forward as ``grand_model``
  runs it (degree scale, ``ops.dia.dia_spmm`` stencil, degree scale, dot,
  bias, tanh); ``agg_xla_<dtype>``: the stencil aggregation alone
  (``ops.spmm.spmm``); ``rhs_triton_<dtype>_bm<rows>_w<warps>``: the kernel.
  Each is ``ITERS`` chained calls in one jitted ``fori_loop``, reported per
  call. ``solve_*`` / ``step_*``: ``grand_model``'s forward solve and its
  loss + gradient (Tsit5, rtol 1e-3, checkpointed adjoint) with the XLA RHS
  or the kernel's.
- ``mlp/*``: the ϕ aggregate at the VMH tutorial widths (4→60→60→60, tanh)
  on the tutorial graph (3000 Delaunay points) under ``vmap`` over 4 sims
  (one microbatch) and 24 sims (one epoch), and on a 32,768-point Delaunay
  mesh; one call per timing. ``vmh_*``: the VMH protocol's forward solve of
  one microbatch and its full epoch gradient, with ``nn.conv.edge_mlp_sum``
  as it is (XLA) or replaced by the kernel.

Output goes to standard output; on the card the first line is the card's
name and power limit. ``ab_kernels.h200.log`` beside this file is the
output of one run on an H200 with a 700 W limit.
"""
from __future__ import annotations

import functools
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import triton as plgpu  # noqa: E402

REPEATS = 7
ITERS = 20
RB, TE = 32, 64  # edge-MLP kernel: receivers per program, edges per chunk


# ------------------------------------------------------- DIA fused GCN RHS
def dia_norm_values(dm, deg):
    """``Â``'s diagonals, transposed and padded for the kernel:
    ``vals_t[k, i] = c_i · A[i, i + d_k] · c_{i + d_k}``, ``c = deg^-1/2``.
    Also returns the same values as a ``DiaMatrix`` for XLA's gradient."""
    from neuralgraphpde.ops.dia import DiaMatrix

    vals = np.asarray(dm.values, np.float64)
    c = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1.0)), 0.0)
    n = dm.num_nodes
    out = np.zeros_like(vals)
    for k, d in enumerate(dm.offsets):
        j = np.arange(n) + d
        ok = (j >= 0) & (j < n)
        out[ok, k] = c[ok] * vals[ok, k] * c[j[ok]]
    norm = DiaMatrix(values=jnp.asarray(out, jnp.float32), offsets=dm.offsets,
                     num_nodes=n)
    return jnp.asarray(out.T, jnp.float32), norm


def _dia_rhs_kernel(vals_ref, xp_ref, w_ref, b_ref, o_ref, *, offsets, bw,
                    bm):
    r0 = pl.program_id(0) * bm
    acc = jnp.zeros((bm, xp_ref.shape[1]), jnp.float32)
    for k, d in enumerate(offsets):
        xk = xp_ref[pl.ds(r0 + bw + d, bm), :].astype(jnp.float32)
        vk = vals_ref[k, pl.ds(r0, bm)].astype(jnp.float32)
        acc += vk[:, None] * xk
    h = acc.astype(xp_ref.dtype)
    y = pl.dot(h, w_ref[...]) + b_ref[...].astype(jnp.float32)
    o_ref[...] = jnp.tanh(y).astype(o_ref.dtype)


def dia_rhs_triton(vals_t, offsets, x, w, b, *, bm=128, num_warps=8,
                   interpret=False):
    """``tanh((Â x) W + b)`` for ``vals_t`` from ``dia_norm_values``."""
    n, f = x.shape
    bw = max(abs(d) for d in offsets)
    n_pad = -(-n // bm) * bm
    xp = jnp.pad(x, ((bw, bw + n_pad - n), (0, 0)))
    vt = jnp.pad(vals_t.astype(x.dtype), ((0, 0), (0, n_pad - n)))
    out = pl.pallas_call(
        functools.partial(_dia_rhs_kernel, offsets=tuple(offsets), bw=bw,
                          bm=bm),
        out_shape=jax.ShapeDtypeStruct((n_pad, w.shape[1]), x.dtype),
        grid=(n_pad // bm,),
        out_specs=pl.BlockSpec((bm, w.shape[1]), lambda i: (i, 0)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=2),
        interpret=interpret,
    )(vt, xp, w.astype(x.dtype), b.astype(x.dtype))
    return out[:n]


def make_dia_rhs(offsets, bm, num_warps, interpret=False):
    """The kernel with XLA's gradient: ``f(vals_t, norm, x, w, b)``."""
    from neuralgraphpde.ops.dia import dia_spmm, transpose_dia

    @jax.custom_vjp
    def rhs(vals_t, norm, x, w, b):
        return dia_rhs_triton(vals_t, offsets, x, w, b, bm=bm,
                              num_warps=num_warps, interpret=interpret)

    def fwd(vals_t, norm, x, w, b):
        y = rhs(vals_t, norm, x, w, b)
        return y, (norm, x, w, y)

    def bwd(res, dy):
        norm, x, w, y = res
        yf = y.astype(jnp.float32)
        dz = (dy.astype(jnp.float32) * (1.0 - yf * yf)).astype(x.dtype)
        h = dia_spmm(norm, x)
        dw = jnp.dot(h.T, dz, preferred_element_type=jnp.float32)
        db = jnp.sum(dz.astype(jnp.float32), axis=0, keepdims=True)
        dh = jnp.dot(dz, w.T.astype(dz.dtype), preferred_element_type=x.dtype)
        dx = dia_spmm(transpose_dia(norm), dh)
        return (None, None, dx, dw.astype(w.dtype), db.astype(w.dtype))

    rhs.defvjp(fwd, bwd)
    return rhs


def triton_gcn_layer(feat, bm, num_warps, interpret=False):
    """A ``GCNConv(feat, feat, "tanh")`` stand-in (same parameters) whose
    forward is the kernel. Reads ``Â`` from the graph cache entries
    ``dia_norm_t`` / ``dia_norm`` (added by the caller)."""
    import dataclasses

    from neuralgraphpde import GCNConv

    @dataclasses.dataclass(frozen=True, eq=False)
    class TritonGCN(GCNConv):
        def __call__(self, x, ps, st):
            g = st["graph"]
            norm = g.cache["dia_norm"]
            f = make_dia_rhs(norm.offsets, bm, num_warps, interpret)
            return f(g.cache["dia_norm_t"], norm, x, ps["weight"],
                     ps["bias"]), st

    return TritonGCN(feat, feat, "tanh", add_self_loops=False)


# ------------------------------------------------------ fused edge MLP
def _edge_mlp_kernel(off_ref, feats_ref, recv_ref, *refs, n_layers):
    wb, o_ref = refs[:-1], refs[-1]
    blk = pl.program_id(0)
    e0, e1 = off_ref[blk], off_ref[blk + 1]
    rows = blk * RB + jnp.arange(RB)

    def chunk(c, acc):
        start = e0 + c * TE
        valid = start + jnp.arange(TE) < e1
        h = plgpu.load(feats_ref.at[pl.ds(start, TE), :],
                       mask=valid[:, None], other=0.0)
        for i in range(n_layers):
            h = jnp.tanh(pl.dot(h, wb[2 * i][...]).astype(jnp.float32)
                         + wb[2 * i + 1][...]).astype(feats_ref.dtype)
        r = plgpu.load(recv_ref.at[pl.ds(start, TE)], mask=valid, other=-1)
        onehot = (rows[:, None] == r[None, :]).astype(h.dtype)
        return acc + pl.dot(onehot, h).astype(jnp.float32)

    acc = jax.lax.fori_loop(0, (e1 - e0 + TE - 1) // TE, chunk,
                            jnp.zeros(o_ref.shape, jnp.float32))
    o_ref[...] = acc.astype(o_ref.dtype)


def _pow2(v, lo):
    return max(lo, 1 << (int(v) - 1).bit_length())


def edge_mlp_triton(feats, ws, bs, receivers, num_nodes, *, num_warps=4,
                    interpret=False):
    """``Σ_{e→i} ϕ(feats_e)`` for a tanh Dense stack ϕ over receiver-sorted
    edges (the XLA version is ``nn.conv.edge_mlp_sum``)."""
    e, fin = feats.shape
    dims = [fin] + [w.shape[1] for w in ws]
    pdims = [_pow2(dims[0], 16)] + [_pow2(d, 16) for d in dims[1:]]
    wb = []
    for i, (w, b) in enumerate(zip(ws, bs)):
        wp = jnp.zeros((pdims[i], pdims[i + 1]), feats.dtype)
        wb.append(wp.at[:w.shape[0], :w.shape[1]].set(w.astype(feats.dtype)))
        bp = jnp.zeros((1, pdims[i + 1]), jnp.float32)
        wb.append(bp.at[:, :b.shape[1]].set(b.astype(jnp.float32)))
    nb = -(-num_nodes // RB)
    # a chunk may start TE-1 edges before the end: pad so no read runs off
    fp = jnp.zeros((e + TE, pdims[0]), feats.dtype).at[:e, :fin].set(feats)
    rp = jnp.concatenate([receivers.astype(jnp.int32),
                          jnp.full((TE,), -1, jnp.int32)])
    offs = jnp.searchsorted(receivers, jnp.arange(nb + 1) * RB,
                            side="left").astype(jnp.int32)
    out = pl.pallas_call(
        functools.partial(_edge_mlp_kernel, n_layers=len(ws)),
        out_shape=jax.ShapeDtypeStruct((nb * RB, pdims[-1]), jnp.float32),
        grid=(nb,),
        out_specs=pl.BlockSpec((RB, pdims[-1]), lambda i: (i, 0)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=2),
        interpret=interpret,
    )(offs, fp, rp, *wb)
    return out[:num_nodes, :dims[-1]].astype(feats.dtype)


def make_edge_mlp_sum(interpret=False):
    """Drop-in for ``nn.conv.edge_mlp_sum``: the kernel for an unweighted
    tanh stack, XLA's autodiff of the plain version for the gradient."""
    from neuralgraphpde.nn import conv

    plain = conv.edge_mlp_sum

    @functools.partial(jax.custom_vjp, nondiff_argnums=(4,))
    def fused(feats, ws, bs, receivers, num_nodes):
        return edge_mlp_triton(feats, ws, bs, receivers, num_nodes,
                               interpret=interpret)

    def fwd(feats, ws, bs, receivers, num_nodes):
        return fused(feats, ws, bs, receivers, num_nodes), (feats, ws, bs,
                                                            receivers)

    def bwd(num_nodes, res, g):
        feats, ws, bs, receivers = res
        acts = ("tanh",) * len(ws)
        _, vjp = jax.vjp(lambda f, w, b: plain(acts, f, w, b, receivers,
                                               num_nodes), feats, ws, bs)
        return (*vjp(g), None)

    fused.defvjp(fwd, bwd)

    def edge_mlp_sum(acts, feats, ws, bs, receivers, num_nodes,
                     weights=None):
        if weights is not None or any(a != "tanh" for a in acts):
            return plain(acts, feats, ws, bs, receivers, num_nodes, weights)
        return fused(feats, tuple(ws), tuple(bs), receivers, num_nodes)

    return edge_mlp_sum


# ---------------------------------------------------------------- timing
def timed(fn, *args):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2], ts[0], ts[-1]


def report(name, t, per=1, unit="us"):
    scale = {"us": 1e6, "ms": 1e3, "s": 1.0}[unit] / per
    med, lo, hi = (v * scale for v in t)
    print(f"{name}: {med:.1f} {unit} (min {lo:.1f}, max {hi:.1f})",
          flush=True)


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def chained(rhs):
    @jax.jit
    def loop(x, *args):
        return jax.lax.fori_loop(0, ITERS, lambda i, v: rhs(v, *args), x)

    return loop


# ------------------------------------------------------------- DIA A/B
def ab_dia(feat=128, nx=512, classes=8):
    import optax  # noqa: F401  (same installation check as the trainers)

    from neuralgraphpde import GCNConv, precompute, setup, update_graph
    from neuralgraphpde.graph.builders import grid_graph_2d
    from neuralgraphpde.models import grand_model
    from neuralgraphpde.nn.basic import Chain
    from neuralgraphpde.ops.spmm import spmm

    g = precompute(grid_graph_2d(nx, nx, diagonals=True), add_self_loops=True)
    deg = np.asarray(g.cache["in_degree"], np.float64)
    vals_t, norm = dia_norm_values(g.cache["dia"], deg)
    g = g.copy(cache={**g.cache, "dia_norm_t": vals_t, "dia_norm": norm})
    n = g.num_nodes
    print(f"dia: grid {nx}x{nx} nodes={n} edges={g.num_edges} "
          f"offsets={len(norm.offsets)} F={feat}", flush=True)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(n, feat)), jnp.float32)
    layer = GCNConv(feat, feat, "tanh", add_self_loops=False)
    ps, st = setup(jax.random.PRNGKey(0), layer)
    ps = {**ps, "bias": 0.1 * jnp.ones_like(ps["bias"])}
    st = update_graph(st, g)

    with jax.default_matmul_precision("highest"):
        want = layer(x, ps, st)[0]
        got = triton_gcn_layer(feat, 128, 8)(x, ps, st)[0]
    print(f"dia/rhs_triton f32 vs rhs_xla at highest: rel_err="
          f"{rel(got, want):.3e}", flush=True)

    configs = [(64, 4), (128, 4), (128, 8)]
    for dt in (jnp.float32, jnp.bfloat16):
        tag = "f32" if dt == jnp.float32 else "bf16"
        xd = x.astype(dt)
        psd = jax.tree_util.tree_map(lambda a: a.astype(dt), ps)
        report(f"dia/agg_xla_{tag}",
               timed(chained(lambda v, g: spmm(g, v)), xd, g), ITERS)
        report(f"dia/rhs_xla_{tag}",
               timed(chained(lambda v, ps, st: layer(v, ps, st)[0]), xd, psd,
                     st), ITERS)
        for bm, nw in configs:
            tl = triton_gcn_layer(feat, bm, nw)
            report(f"dia/rhs_triton_{tag}_bm{bm}_w{nw}",
                   timed(chained(lambda v, ps, st, tl=tl: tl(v, ps, st)[0]),
                         xd, psd, st), ITERS)

    # end to end: grand_model with its ODE RHS from XLA or from the kernel
    def models(bm, nw):
        base = grand_model(feat, feat, classes, precomputed_self_loops=True)
        ode = base.layers[1]
        rhs = Chain(tuple(triton_gcn_layer(feat, bm, nw) for _ in range(2)))
        import dataclasses

        tri = Chain((base.layers[0], dataclasses.replace(ode, model=rhs),
                     base.layers[2]))
        return base, tri

    base, tri = models(128, 8)
    mps, mst = setup(jax.random.PRNGKey(0), base)
    mst = update_graph(mst, g)
    labels = jnp.asarray(rng.integers(0, classes, n))

    def loss(model):
        def f(p, x, st, y):
            logp = jax.nn.log_softmax(model(x, p, st)[0], axis=-1)
            return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=-1))
        return f

    for name, model in (("xla", base), ("triton", tri)):
        solve = jax.jit(lambda p, x, st, m=model: m(x, p, st)[0])
        step = jax.jit(jax.value_and_grad(loss(model)))
        report(f"dia/solve_{name}", timed(solve, mps, x, mst), unit="ms")
        report(f"dia/step_{name}", timed(step, mps, x, mst, labels),
               unit="ms")
    with jax.default_matmul_precision("highest"):
        lx, gx = jax.jit(jax.value_and_grad(loss(base)))(mps, x, mst, labels)
        lt, gt = jax.jit(jax.value_and_grad(loss(tri)))(mps, x, mst, labels)
    gerr = max(rel(a, b) for a, b in zip(jax.tree_util.tree_leaves(gt),
                                         jax.tree_util.tree_leaves(gx)))
    print(f"dia/step triton vs xla at highest: loss rel_err={rel(lt, lx):.3e}"
          f" grads (max) rel_err={gerr:.3e}", flush=True)


# --------------------------------------------------------- edge-MLP A/B
def ab_edge_mlp():
    from neuralgraphpde import MLP, precompute, setup
    from neuralgraphpde.graph.builders import delaunay_graph
    from neuralgraphpde.nn import conv

    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "examples"))
    import train_vmh

    phi = MLP((4, 60, 60, 60, 40), "tanh")
    ps, _ = setup(jax.random.PRNGKey(0), phi)
    acts, ws, bs, _ = conv.fused_phi_plan(phi, ps, "mean")
    rng = np.random.default_rng(0)
    kernel = make_edge_mlp_sum()

    cfg = train_vmh.Config()
    data = train_vmh.setup(cfg).data
    cases = [("tutorial_4sims", data.graph, 4),
             ("tutorial_24sims", data.graph, 24)]
    pts = rng.random((1 << 15, 2)).astype(np.float32)
    cases.append(("delaunay32k", delaunay_graph(pts, ndata={"x": pts}), 0))
    for name, g0, sims in cases:
        g = precompute(g0, dense=False)
        e, n = g.num_edges, g.num_nodes
        shape = (sims, e, 4) if sims else (e, 4)
        feats = jnp.asarray(rng.normal(size=shape), jnp.float32)
        recv = g.receivers
        print(f"mlp/{name}: nodes={n} edges={e} sims={sims or 1}",
              flush=True)
        for tag, fn in (("xla", conv.edge_mlp_sum), ("triton", kernel)):
            def one(f, ws, bs, recv, fn=fn):
                return fn(acts, f, ws, bs, recv, n)

            call = jax.jit(jax.vmap(one, in_axes=(0, None, None, None))
                           if sims else one)
            if tag == "xla":
                with jax.default_matmul_precision("highest"):
                    want = call(feats, ws, bs, recv)
            else:
                with jax.default_matmul_precision("highest"):
                    got = call(feats, ws, bs, recv)
                print(f"mlp/{name} triton vs xla at highest: rel_err="
                      f"{rel(got, want):.3e}", flush=True)
            report(f"mlp/{name}_{tag}", timed(call, feats, ws, bs, recv))

    # end to end: the VMH protocol with ϕ's aggregate from XLA or the kernel
    plain = conv.edge_mlp_sum
    for tag, fn in (("xla", plain), ("triton", kernel)):
        conv.edge_mlp_sum = fn
        try:
            tr = train_vmh.setup(cfg, data=data)
            fwd = jax.jit(lambda p, u, st, m=tr.model: jnp.mean(
                jax.vmap(lambda ut: m(ut[0], p, st)[0])(u)))
            report(f"vmh/solve_{tag}", timed(fwd, tr.ps, tr.u[:tr.mb], tr.st),
                   unit="ms")
            report(f"vmh/epoch_gradient_{tag}",
                   timed(lambda p: train_vmh.epoch_gradient(tr, p), tr.ps),
                   unit="s")
            loss, grads = train_vmh.epoch_gradient(tr, tr.ps)
            if tag == "xla":
                ref = (loss, grads)
            else:
                gerr = max(rel(a, b) for a, b in zip(
                    jax.tree_util.tree_leaves(grads),
                    jax.tree_util.tree_leaves(ref[1])))
                print(f"vmh/epoch triton vs xla (default precision): loss "
                      f"rel_err={rel(loss, ref[0]):.3e} grads (max) "
                      f"rel_err={gerr:.3e}", flush=True)
        finally:
            conv.edge_mlp_sum = plain


# ------------------------------------------------------------ CPU check
def check():
    """Both kernels in interpret mode on tiny shapes, values and gradients
    against the plain versions."""
    from neuralgraphpde import precompute, setup, update_graph
    from neuralgraphpde import GCNConv
    from neuralgraphpde.graph.builders import grid_graph_2d, rand_graph
    from neuralgraphpde.nn import conv

    rng = np.random.default_rng(0)
    g = precompute(grid_graph_2d(20, 13, diagonals=True), add_self_loops=True,
                   dense=False)
    vals_t, norm = dia_norm_values(g.cache["dia"],
                                   np.asarray(g.cache["in_degree"]))
    g = g.copy(cache={**g.cache, "dia_norm_t": vals_t, "dia_norm": norm})
    layer = GCNConv(16, 16, "tanh", add_self_loops=False)
    ps, st = setup(jax.random.PRNGKey(0), layer)
    ps = {**ps, "bias": 0.1 * jnp.ones_like(ps["bias"])}
    st = update_graph(st, g)
    x = jnp.asarray(rng.normal(size=(g.num_nodes, 16)), jnp.float32)
    tl = triton_gcn_layer(16, 64, 4, interpret=True)
    with jax.default_matmul_precision("highest"):
        f = lambda l: lambda p, x: jnp.sum(jnp.sin(l(x, p, st)[0]))
        errs = [rel(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(jax.value_and_grad(f(tl), (0, 1))(ps, x)),
            jax.tree_util.tree_leaves(
                jax.value_and_grad(f(layer), (0, 1))(ps, x)))]
    print(f"check dia_gcn_rhs: max rel_err {max(errs):.2e}")
    assert max(errs) < 1e-5, errs

    gr = precompute(rand_graph(150, 900, seed=0), dense=False)
    dims = (4, 60, 60, 60)
    ws = tuple(jnp.asarray(rng.normal(size=(a, b)) / np.sqrt(a), jnp.float32)
               for a, b in zip(dims[:-1], dims[1:]))
    bs = tuple(jnp.asarray(rng.normal(size=(1, b)), jnp.float32)
               for b in dims[1:])
    feats = jnp.asarray(rng.normal(size=(3, gr.num_edges, 4)), jnp.float32)
    acts = ("tanh",) * 3
    kernel = make_edge_mlp_sum(interpret=True)

    def loss(fn):
        return lambda f, w: jnp.sum(jnp.sin(jax.vmap(
            lambda f1: fn(acts, f1, w, bs, gr.receivers, gr.num_nodes))(f)))

    with jax.default_matmul_precision("highest"):
        got = jax.value_and_grad(loss(kernel), (0, 1))(feats, ws)
        want = jax.value_and_grad(loss(conv.edge_mlp_sum), (0, 1))(feats, ws)
    errs = [rel(a, b) for a, b in zip(jax.tree_util.tree_leaves(got),
                                      jax.tree_util.tree_leaves(want))]
    print(f"check edge_mlp: max rel_err {max(errs):.2e}")
    assert max(errs) < 1e-5, errs


def main(argv):
    if "--check" in argv:
        jax.config.update("jax_platforms", "cpu")
        check()
        return 0
    if jax.devices()[0].platform != "gpu":
        print("ab_kernels: needs a GPU (use --check on the CPU)",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    print(f"jax {jax.__version__}: {jax.devices()[0].device_kind}, "
          f"repeats={REPEATS}, chained calls={ITERS}", flush=True)
    which = [a for a in argv if not a.startswith("-")] or ["dia", "mlp"]
    if "dia" in which:
        ab_dia()
    if "mlp" in which:
        ab_edge_mlp()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
