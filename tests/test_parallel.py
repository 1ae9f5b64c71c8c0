"""Multi-device tests on the 8-device virtual CPU mesh: partitioning
round-trips, sharded SpMM/GCN parity vs single-device, distributed GRAND
train step (SURVEY §4 multi-host test plan)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neuralgraphpde import (
    GCNConv, GnnGraph, add_self_loops, rand_graph, setup, spmm,
)
from neuralgraphpde.parallel import (
    make_mesh, pad_node_features, partition_graph, replicate,
    shard_node_features, sharded_gcn_forward, sharded_grand_model,
    sharded_spmm, ShardedGCNConv,
)

NDEV = 8


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= NDEV, "conftest must provide 8 cpu devices"
    return make_mesh(NDEV)


def test_partition_roundtrip_spmm(mesh):
    g = rand_graph(100, 700, seed=0)
    pg = partition_graph(g, NDEV)
    x = np.random.default_rng(0).normal(size=(100, 16)).astype(np.float32)
    want = np.asarray(spmm(g, jnp.asarray(x)))

    xp = shard_node_features(pad_node_features(x, pg), pg, mesh)
    got = np.asarray(sharded_spmm(pg, xp, mesh))[: g.num_nodes]
    assert np.allclose(got, want, atol=1e-5)


def test_partition_uneven_nodes(mesh):
    # node count not divisible by device count exercises padding
    g = rand_graph(101, 643, seed=1)
    pg = partition_graph(g, NDEV)
    assert pg.padded_nodes >= 101
    x = np.random.default_rng(1).normal(size=(101, 8)).astype(np.float32)
    want = np.asarray(spmm(g, jnp.asarray(x)))
    xp = shard_node_features(pad_node_features(x, pg), pg, mesh)
    got = np.asarray(sharded_spmm(pg, xp, mesh))[: g.num_nodes]
    assert np.allclose(got, want, atol=1e-5)


def test_sharded_gcn_matches_single_device(mesh):
    g = rand_graph(64, 512, seed=2)
    gl = add_self_loops(g)
    pg = partition_graph(gl, NDEV)

    x = np.random.default_rng(2).normal(size=(64, 12)).astype(np.float32)
    l = GCNConv(12, 20, "tanh", initialgraph=g)
    ps, st = setup(jax.random.PRNGKey(0), l)
    want, _ = l(jnp.asarray(x), ps, st)

    xp = shard_node_features(pad_node_features(x, pg), pg, mesh)
    got = sharded_gcn_forward(pg, xp, ps["weight"], ps["bias"], mesh,
                              activation=jnp.tanh)
    assert np.allclose(np.asarray(got)[:64], np.asarray(want), atol=1e-5)


@pytest.mark.slow
def test_sharded_gcn_out_lt_in_premultiply(mesh):
    g = rand_graph(64, 512, seed=3)
    gl = add_self_loops(g)
    pg = partition_graph(gl, NDEV)
    x = np.random.default_rng(3).normal(size=(64, 16)).astype(np.float32)
    l = GCNConv(16, 4, initialgraph=g)
    ps, st = setup(jax.random.PRNGKey(1), l)
    want, _ = l(jnp.asarray(x), ps, st)
    xp = shard_node_features(pad_node_features(x, pg), pg, mesh)
    got = sharded_gcn_forward(pg, xp, ps["weight"], ps["bias"], mesh)
    assert np.allclose(np.asarray(got)[:64], np.asarray(want), atol=1e-5)


@pytest.mark.slow
def test_distributed_grand_train_step(mesh):
    """Full distributed training step: sharded features, replicated params,
    grad through the ODE solve + halo exchanges."""
    import optax

    g = add_self_loops(rand_graph(64, 300, seed=4))
    pg = partition_graph(g, NDEV)
    model = sharded_grand_model(8, 16, 3, mesh, initialgraph=lambda: pg,
                                rtol=1e-3, atol=1e-3)
    ps, st = setup(jax.random.PRNGKey(0), model)

    x = np.random.default_rng(4).normal(size=(64, 8)).astype(np.float32)
    y = np.random.default_rng(5).integers(0, 3, size=64)
    xp = shard_node_features(pad_node_features(x, pg), pg, mesh)
    labels = jnp.asarray(y)

    opt = optax.adam(1e-2)
    opt_state = opt.init(ps)

    def loss_fn(ps, xp):
        logits, _ = model(xp, ps, st)
        logits = logits[: g.num_nodes]
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.mean(
            jnp.take_along_axis(logp, labels[:, None], axis=-1))

    @jax.jit
    def step(ps, opt_state, xp):
        loss, grads = jax.value_and_grad(loss_fn)(ps, xp)
        updates, opt_state = opt.update(grads, opt_state, ps)
        return optax.apply_updates(ps, updates), opt_state, loss

    ps2, opt_state, loss = step(ps, opt_state, xp)
    assert np.isfinite(float(loss))
    # params actually changed
    delta = sum(float(jnp.sum(jnp.abs(a - b)))
                for a, b in zip(jax.tree_util.tree_leaves(ps),
                                jax.tree_util.tree_leaves(ps2)))
    assert delta > 0


def test_sharded_layer_in_state_protocol(mesh):
    g = add_self_loops(rand_graph(32, 128, seed=6))
    pg = partition_graph(g, NDEV)
    l = ShardedGCNConv(4, 4, mesh=mesh, initialgraph=lambda: pg)
    ps, st = setup(jax.random.PRNGKey(0), l)
    x = shard_node_features(
        pad_node_features(np.ones((32, 4), np.float32), pg), pg, mesh)
    y, st2 = l(x, ps, st)
    assert y.shape[0] == pg.padded_nodes


@pytest.mark.slow
def test_halo_exchange_matches_allgather(mesh):
    """Targeted all_to_all halo must agree with the all_gather variant and
    with single-device spmm, including uneven node counts."""
    for n, e, seed in [(96, 600, 7), (101, 500, 8)]:
        g = rand_graph(n, e, seed=seed)
        pg_halo = partition_graph(g, NDEV, halo=True)
        pg_ag = partition_graph(g, NDEV, halo=False)
        assert pg_halo.senders_halo is not None
        x = np.random.default_rng(seed).normal(size=(n, 8)).astype(np.float32)
        want = np.asarray(spmm(g, jnp.asarray(x)))
        for pg in (pg_halo, pg_ag):
            xp = shard_node_features(pad_node_features(x, pg), pg, mesh)
            got = np.asarray(sharded_spmm(pg, xp, mesh))[:n]
            assert np.allclose(got, want, atol=1e-5)


@pytest.mark.slow
def test_halo_gcn_matches_single_device(mesh):
    from neuralgraphpde import GCNConv, setup

    g = rand_graph(64, 512, seed=9)
    gl = add_self_loops(g)
    pg = partition_graph(gl, NDEV, halo=True)
    x = np.random.default_rng(9).normal(size=(64, 12)).astype(np.float32)
    l = GCNConv(12, 20, "tanh", initialgraph=g)
    ps, st = setup(jax.random.PRNGKey(0), l)
    want, _ = l(jnp.asarray(x), ps, st)
    xp = shard_node_features(pad_node_features(x, pg), pg, mesh)
    got = sharded_gcn_forward(pg, xp, ps["weight"], ps["bias"], mesh,
                              activation=jnp.tanh)
    assert np.allclose(np.asarray(got)[:64], np.asarray(want), atol=1e-5)


def test_halo_volume_small_for_spatial_graph(mesh):
    """On a spatially-ordered 2D lattice, halo rows per pair must be far
    below nodes_per_part (the point of the targeted exchange)."""
    from neuralgraphpde import grid_graph_2d

    g = grid_graph_2d(40, 40)  # row-major ordering = spatial locality
    pg = partition_graph(g, NDEV, halo=True)
    assert pg.halo_size < pg.nodes_per_part / 2


def test_sharded_propagate_custom_message(mesh):
    """Distributed custom-message propagate (VMH-style difference message
    with edge features) vs single-device ops.propagate."""
    from neuralgraphpde.ops import propagate
    from neuralgraphpde.parallel import sharded_propagate

    rng = np.random.default_rng(11)
    g = rand_graph(64, 400, seed=11,
                   edata={"w": rng.normal(size=(400, 3)).astype(np.float32)})
    x = rng.normal(size=(64, 6)).astype(np.float32)

    pg = partition_graph(g, NDEV, halo=True)

    def message_single(xi, xj, e):
        return jnp.concatenate([xj - xi, e["w"]], axis=-1)

    want = np.asarray(propagate(message_single, g, "mean",
                                xi=jnp.asarray(x), xj=jnp.asarray(x),
                                e=g.edata))

    def message_dist(xi, xj, e):
        return jnp.concatenate([xj - xi, e["w"]], axis=-1)

    xp = shard_node_features(pad_node_features(x, pg), pg, mesh)
    got = np.asarray(sharded_propagate(pg, message_dist, xp, mesh,
                                       aggr="mean"))[: g.num_nodes]
    assert np.allclose(got, want, atol=1e-5)


@pytest.mark.slow
def test_sharded_vmh_matches_single_device(mesh):
    """Edge-partitioned VMHConv must match the single-device layer."""
    from neuralgraphpde import Dense, VMHConv
    from neuralgraphpde.parallel import ShardedVMHConv

    rng = np.random.default_rng(12)
    pos = rng.normal(size=(48, 2)).astype(np.float32)
    g = rand_graph(48, 256, seed=12, ndata={"x": pos})
    h = rng.normal(size=(48, 4)).astype(np.float32)

    phi = Dense(4 + 4 + 2, 6, "tanh")
    gamma = Dense(4 + 6, 5)
    l = VMHConv(phi, gamma, initialgraph=g)
    ps, st = setup(jax.random.PRNGKey(3), l)
    want, _ = l(jnp.asarray(h), ps, st)

    pg = partition_graph(g, NDEV, halo=True)
    ld = ShardedVMHConv(phi, gamma, mesh=mesh, initialgraph=lambda: pg)
    std = ld.initialstates(jax.random.PRNGKey(3))
    hp = shard_node_features(pad_node_features(h, pg), pg, mesh)
    got, _ = ld(hp, ps, std)
    assert np.allclose(np.asarray(got)[:48], np.asarray(want), atol=1e-5)


def test_tensor_parallel_mlp_matches_replicated():
    """Column-sharded MLP params under jit must produce identical outputs
    (GSPMD inserts the collectives)."""
    from jax.sharding import Mesh
    from neuralgraphpde import MLP, setup
    from neuralgraphpde.parallel import shard_mlp_params

    mesh = Mesh(np.asarray(jax.devices()[:NDEV]), ("model",))
    mlp = MLP((64, 512, 512, 32), activation="tanh")
    ps, st = setup(jax.random.PRNGKey(0), mlp)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(16, 64))
                    .astype(np.float32))

    want, _ = mlp(x, ps, st)
    ps_tp = shard_mlp_params(ps, mesh, "model", min_dim=256)

    @jax.jit
    def fwd(x, ps):
        y, _ = mlp(x, ps, st)
        return y

    got = fwd(x, ps_tp)
    assert np.allclose(np.asarray(got), np.asarray(want), atol=1e-5)
    # the big kernels actually got sharded
    shardings = {k: v.sharding.spec for k, v in
                 [("l1", ps_tp["layer_1"]["weight"]),
                  ("l2", ps_tp["layer_2"]["weight"])]}
    assert any("model" in str(s) for s in shardings.values())


@pytest.mark.slow
def test_sharded_mppde_matches_single_device(mesh):
    from neuralgraphpde import Dense, MPPDEConv
    from neuralgraphpde.parallel import ShardedMPPDEConv

    rng = np.random.default_rng(14)
    nd = {"u": rng.normal(size=(48, 2)).astype(np.float32),
          "x": rng.normal(size=(48, 1)).astype(np.float32)}
    # θ in gdata (reference src/layers.jl:397): must ride PartitionedGraph
    gd = {"theta": rng.normal(size=(1, 3)).astype(np.float32)}
    g = rand_graph(48, 240, seed=14, ndata=nd, gdata=gd)
    h = rng.normal(size=(48, 4)).astype(np.float32)
    phi = Dense(4 + 4 + 3 + 3, 6, "tanh")
    psi = Dense(4 + 6 + 3, 5)

    l = MPPDEConv(phi, psi, initialgraph=g)
    ps, st = setup(jax.random.PRNGKey(6), l)
    want, _ = l(jnp.asarray(h), ps, st)

    pg = partition_graph(g, NDEV, halo=True)
    assert "theta" in pg.gdata
    ld = ShardedMPPDEConv(phi, psi, mesh=mesh, initialgraph=lambda: pg)
    std = ld.initialstates(jax.random.PRNGKey(6))
    hp = shard_node_features(pad_node_features(h, pg), pg, mesh)
    got, _ = ld(hp, ps, std)
    assert np.allclose(np.asarray(got)[:48], np.asarray(want), atol=1e-5)

    # θ gets no gradient distributed either (stop_gradient parity with the
    # reference's @ignore_derivatives)
    def loss(hp):
        y, _ = ld(hp, ps, std)
        return jnp.sum(y[:48] ** 2)

    gx = jax.grad(loss)(hp)
    assert np.all(np.isfinite(np.asarray(gx)))


@pytest.mark.slow
def test_sharded_propagate_max_min_match_single_device(mesh):
    from neuralgraphpde.ops import propagate, xj_sub_xi
    from neuralgraphpde.parallel.halo import sharded_propagate

    rng = np.random.default_rng(21)
    g = rand_graph(48, 240, seed=21)
    x = rng.normal(size=(48, 5)).astype(np.float32)
    pg = partition_graph(g, NDEV, halo=True)
    xp = shard_node_features(pad_node_features(x, pg), pg, mesh)

    for aggr in ("max", "min"):
        want = np.asarray(propagate(xj_sub_xi, g, aggr,
                                    xi=jnp.asarray(x), xj=jnp.asarray(x)))
        got = np.asarray(sharded_propagate(
            pg, lambda xi, xj, e: xj - xi, xp, mesh, aggr=aggr))[:48]
        # rand_graph may leave isolated receivers: ±inf on both sides there
        finite = np.isfinite(want)
        assert np.array_equal(finite, np.isfinite(got))
        assert np.allclose(got[finite], want[finite], atol=1e-6), aggr


@pytest.mark.slow
def test_sharded_gno_matches_single_device(mesh):
    from neuralgraphpde import Dense, GNOConv
    from neuralgraphpde.parallel import ShardedGNOConv

    rng = np.random.default_rng(15)
    nd = {"a": rng.normal(size=(40, 2)).astype(np.float32),
          "x": rng.normal(size=(40, 2)).astype(np.float32)}
    g = rand_graph(40, 200, seed=15, ndata=nd)
    in_chs, out_chs = 3, 4
    h = rng.normal(size=(40, in_chs)).astype(np.float32)
    phi = Dense(8, in_chs * out_chs)

    l = GNOConv(in_chs, out_chs, phi, "tanh", initialgraph=g)
    ps, st = setup(jax.random.PRNGKey(7), l)
    want, _ = l(jnp.asarray(h), ps, st)

    pg = partition_graph(g, NDEV, halo=True)
    ld = ShardedGNOConv(in_chs, out_chs, phi, "tanh", mesh=mesh,
                        initialgraph=lambda: pg)
    std = ld.initialstates(jax.random.PRNGKey(7))
    hp = shard_node_features(pad_node_features(h, pg), pg, mesh)
    got, _ = ld(hp, ps, std)
    assert np.allclose(np.asarray(got)[:40], np.asarray(want), atol=1e-5)


def test_reorder_for_partition_balances_and_preserves(mesh):
    """Greedy-reordered partition must balance edge load on a skewed graph
    and preserve aggregation results."""
    from neuralgraphpde.parallel import reorder_for_partition

    rng = np.random.default_rng(16)
    # skewed receivers: 80% of edges into the first 16 nodes
    n, e = 128, 2000
    hot = rng.integers(0, 16, int(e * 0.8))
    cold = rng.integers(16, n, e - len(hot))
    r = np.concatenate([hot, cold]).astype(np.int32)
    s = rng.integers(0, n, e).astype(np.int32)
    x = rng.normal(size=(n, 8)).astype(np.float32)
    g = GnnGraph.from_coo(s, r, num_nodes=n)

    g2, perm = reorder_for_partition(g, NDEV)
    pg_naive = partition_graph(g, NDEV)
    pg_bal = partition_graph(g2, NDEV)
    # padded edge width reflects the worst partition; balancing must shrink it
    assert pg_bal.senders_global.shape[1] < pg_naive.senders_global.shape[1]

    want = np.asarray(spmm(g, jnp.asarray(x)))
    xp = shard_node_features(pad_node_features(x[perm], pg_bal), pg_bal, mesh)
    got = np.asarray(sharded_spmm(pg_bal, xp, mesh))[:n]
    # map back: got[new_id] corresponds to want[perm[new_id]]
    assert np.allclose(got, want[perm], atol=1e-5)


@pytest.mark.slow
def test_overlap_split_metadata_and_parity():
    """Interior/boundary split: metadata is consistent (interior senders
    local, boundary senders index received halo rows) and the overlapped
    sharded_spmm matches the single-device SpMM."""
    import numpy as np

    from neuralgraphpde.graph.builders import grid_graph_2d
    from neuralgraphpde.parallel.halo import make_mesh, sharded_spmm
    from neuralgraphpde.parallel.partition import (
        pad_node_features, partition_graph, unpad_node_features,
    )

    g = grid_graph_2d(16, 32)
    P_ = 8
    pg = partition_graph(g, P_)
    assert pg.senders_int is not None
    npp = pg.nodes_per_part
    # interior senders are local rows; boundary senders index halo rows
    assert int(jnp.max(pg.senders_int)) < npp
    assert pg.senders_bnd.shape[1] <= pg.senders_int.shape[1]  # mesh: few bnd
    n_int = int(jnp.sum(pg.mask_int))
    n_bnd = int(jnp.sum(pg.mask_bnd))
    assert n_int + n_bnd == g.num_edges

    mesh = make_mesh(P_)
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(g.num_nodes, 8)).astype(np.float32))
    xp = jnp.asarray(pad_node_features(np.asarray(x), pg))
    with mesh:
        y = sharded_spmm(pg, xp, mesh)
    y = unpad_node_features(y, pg)

    from neuralgraphpde.ops.spmm import spmm_xla

    want = spmm_xla(g, x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_sharded_spmm_2d_mesh_feature_axis():
    """2-D graph x model layout: the graph axis partitions nodes/edges, the
    model axis shards the feature columns. The halo all_to_all stays on the
    graph axis; every model shard aggregates its own columns. Must match
    the single-device SpMM exactly, forward and gradient."""
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    devs = np.asarray(jax.devices()[:8]).reshape(4, 2)
    mesh2 = Mesh(devs, ("graph", "model"))

    g = rand_graph(96, 640, seed=21)
    pg = partition_graph(g, 4, halo=True)
    x = np.random.default_rng(21).normal(size=(96, 16)).astype(np.float32)
    want = np.asarray(spmm(g, jnp.asarray(x)))

    xp = jax.device_put(
        pad_node_features(x, pg),
        NamedSharding(mesh2, P("graph", "model")))
    got = sharded_spmm(pg, xp, mesh2, feature_axis="model")
    assert got.sharding.spec == P("graph", "model")
    assert np.allclose(np.asarray(got)[: g.num_nodes], want, atol=1e-5)

    def loss(xp):
        return jnp.sum(
            sharded_spmm(pg, xp, mesh2, feature_axis="model")
            [: g.num_nodes] ** 2)

    gx = jax.grad(loss)(xp)
    # reference gradient: d/dx sum((A x)^2) = 2 A^T A x on the same padding
    pad = np.asarray(xp)
    a = np.zeros((g.num_nodes, g.num_nodes), np.float32)
    np.add.at(a, (np.asarray(g.receivers), np.asarray(g.senders)), 1.0)
    want_g = 2.0 * a.T @ (a @ pad[: g.num_nodes])
    assert np.allclose(np.asarray(gx)[: g.num_nodes], want_g, atol=1e-4)


def test_row_parallel_pairing_with_2d_spmm():
    """Megatron pairing on the 2-D mesh: sharded_spmm leaves features
    sharded on the model axis; row_parallel_dense contracts that axis away
    with one psum. End to end must equal dense reference A@X@W + b."""
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P
    from neuralgraphpde.parallel import row_parallel_dense

    devs = np.asarray(jax.devices()[:8]).reshape(4, 2)
    mesh2 = Mesh(devs, ("graph", "model"))

    g = rand_graph(80, 480, seed=31)
    pg = partition_graph(g, 4, halo=True)
    rng = np.random.default_rng(31)
    x = rng.normal(size=(80, 8)).astype(np.float32)
    w = rng.normal(size=(8, 12)).astype(np.float32)
    b = rng.normal(size=(1, 12)).astype(np.float32)

    a = np.zeros((80, 80), np.float32)
    np.add.at(a, (np.asarray(g.receivers), np.asarray(g.senders)), 1.0)
    want = a @ x @ w + b

    xp = jax.device_put(pad_node_features(x, pg),
                        NamedSharding(mesh2, P("graph", "model")))
    agg = sharded_spmm(pg, xp, mesh2, feature_axis="model")
    y = row_parallel_dense(agg, jnp.asarray(w), jnp.asarray(b), mesh=mesh2,
                           axis_name="model", x_specs=P("graph", "model"))
    assert y.sharding.spec == P("graph", None)
    assert np.allclose(np.asarray(y)[: g.num_nodes], want, atol=1e-4)


def test_neighbor_only_halo_detection_and_parity(mesh):
    """Strip partitions of a grid mesh only exchange with adjacent
    partitions: partition_graph must flag halo_neighbor_only, and the
    2-ppermute exchange must match the dense all_to_all bit-for-bit
    (forward and gradient) — it ships 2·H rows instead of (P-1)·H."""
    import dataclasses

    from neuralgraphpde.graph.builders import grid_graph_2d

    g = grid_graph_2d(64, 16, diagonals=True)
    pg = partition_graph(g, 8, halo=True)
    assert pg.halo_neighbor_only
    # uniform random graphs exchange with everyone — flag must stay off
    gr = rand_graph(512, 512 * 8, seed=0)
    assert not partition_graph(gr, 8, halo=True).halo_neighbor_only

    # force the same pg through the dense all_to_all for the reference
    pg_dense = dataclasses.replace(pg, halo_neighbor_only=False)
    x_np = np.random.default_rng(0).normal(
        size=(g.num_nodes, 16)).astype(np.float32)
    x = shard_node_features(pad_node_features(x_np, pg), pg, mesh)

    def run(p):
        return sharded_spmm(p, x, mesh)

    got = np.asarray(run(pg))
    want = np.asarray(run(pg_dense))
    np.testing.assert_array_equal(got, want)

    def loss(p, v):
        return jnp.sum(jnp.tanh(sharded_spmm(p, v, mesh)) ** 2)

    gv = np.asarray(jax.grad(lambda v: loss(pg, v))(x))
    wv = np.asarray(jax.grad(lambda v: loss(pg_dense, v))(x))
    np.testing.assert_allclose(gv, wv, rtol=1e-6, atol=1e-6)
