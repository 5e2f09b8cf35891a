"""Port grouping engine (seggroup_tpu_torch.ops.grouping) against the JAX
one on the CPU: every integer output (roots, point counts, labels, edge
lists, masks) exactly equal, float outputs to 1e-6. Covers the eligible-edge
compaction in both of its JAX regimes (compact prefix and overflow to the
full scan), the label-conflict guard and the spatial fallback of
group_unlabeled_clusters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.ops import grouping as J
from seggroup_tpu_torch.ops import grouping as T

torch.set_num_threads(1)


def _graphs(counts, ins, sem):
    j = J.SegGraph(jnp.arange(len(counts), dtype=jnp.int32), jnp.asarray(counts, jnp.int32),
                   jnp.asarray(ins, jnp.int32), jnp.asarray(sem, jnp.int32),
                   jnp.asarray(counts > 0))
    t = T.SegGraph(torch.arange(len(counts), dtype=torch.int32),
                   torch.as_tensor(counts, dtype=torch.int32),
                   torch.as_tensor(ins, dtype=torch.int32),
                   torch.as_tensor(sem, dtype=torch.int32),
                   torch.as_tensor(counts > 0))
    return j, t


def _assert_graph_equal(gj, gt):
    for name in J.SegGraph._fields:
        np.testing.assert_array_equal(getattr(gt, name).numpy(),
                                      np.asarray(getattr(gj, name)), err_msg=name)


def _graph_case(seed, s=512, e_slots=4096, n_edges=1500, n_labeled=60):
    """Multi-label graph: label conflicts, small and empty segments,
    duplicate and self edges, padding edge slots."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 40, s)
    ins = np.full(s, -1, np.int32)
    labeled = rng.choice(s, n_labeled, replace=False)
    ins[labeled] = rng.integers(0, 24, n_labeled)
    sem = np.where(ins >= 0, (ins * 7) % 20, -1).astype(np.int32)
    e = rng.integers(0, s, (n_edges, 2)).astype(np.int32)
    e = e[(counts[e[:, 0]] > 0) & (counts[e[:, 1]] > 0)]
    edges = np.zeros((e_slots, 2), np.int32)
    edges[: len(e)] = e
    ev = np.zeros(e_slots, bool)
    ev[: len(e)] = True
    dists = (rng.random(e_slots) * 10).astype(np.float32)
    return counts, ins, sem, edges, ev, dists


def test_init_graph_and_normalize_edges_match_jax():
    rng = np.random.default_rng(0)
    s = 32
    p2s = rng.integers(0, s + 4, 500).astype(np.int32)  # ids >= s are padding
    p2s[p2s == 5] = 6                                  # an empty segment
    ins = np.where(rng.random(s) < 0.3, rng.integers(0, 5, s), -1).astype(np.int32)
    gj = J.init_graph(jnp.asarray(p2s), jnp.asarray(ins), jnp.asarray(ins), s)
    gt = T.init_graph(torch.from_numpy(p2s), torch.from_numpy(ins), torch.from_numpy(ins), s)
    _assert_graph_equal(gj, gt)
    np.testing.assert_array_equal(T.active_mask(gt).numpy(), np.asarray(J.active_mask(gj)))

    root = np.arange(s, dtype=np.int32)
    root[[2, 3, 9]] = 1  # some merged slots
    gj, gt = gj._replace(root=jnp.asarray(root)), gt._replace(root=torch.from_numpy(root))
    edges = rng.integers(0, s, (80, 2)).astype(np.int32)
    edges[:5] = [[2, 3], [3, 1], [7, 7], [4, 8], [8, 4]]  # self, merged, dups
    ev = rng.random(80) < 0.8
    ej, vj = J.normalize_edges(gj, jnp.asarray(edges), jnp.asarray(ev))
    et, vt = T.normalize_edges(gt, torch.from_numpy(edges), torch.from_numpy(ev))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("i1,i2,s1,s2,do,same", [
    (-1, -1, -1, -1, True, False),
    (-1, 3, -1, 5, True, False),
    (3, -1, 5, -1, True, False),
    (3, -1, 5, 2, True, False),    # sem set on an unlabeled cluster: -s1*s2
    (3, 3, 5, 5, True, False),
    (3, 4, 5, 6, True, False),     # conflict guard: blocked
    (-1, 3, -1, 5, False, False),  # do=False
    (3, 3, 5, 5, True, True),      # r1 == r2
])
def test_union_matches_jax(i1, i2, s1, s2, do, same):
    s = 6
    counts = np.array([3, 4, 5, 6, 7, 8])
    ins = np.full(s, -1, np.int32)
    sem = np.full(s, -1, np.int32)
    ins[1], ins[4], sem[1], sem[4] = i1, i2, s1, s2
    root = np.array([1, 1, 2, 3, 4, 4], np.int32)
    gj, gt = _graphs(counts, ins, sem)
    gj, gt = gj._replace(root=jnp.asarray(root)), gt._replace(root=torch.from_numpy(root))
    r2 = 1 if same else 4
    out_j = J._union(gj, jnp.int32(1), jnp.int32(r2), jnp.asarray(do))
    out_t = T._union(gt, torch.tensor(1, dtype=torch.int32),
                     torch.tensor(r2, dtype=torch.int32), torch.tensor(do))
    _assert_graph_equal(out_j, out_t)


def test_edge_features_match_jax():
    counts, ins, sem, edges, ev, _ = _graph_case(1, s=64, e_slots=256, n_edges=120)
    gj, gt = _graphs(counts, ins, sem)
    ej, vj = J.normalize_edges(gj, jnp.asarray(edges), jnp.asarray(ev))
    et, vt = T.normalize_edges(gt, torch.from_numpy(edges), torch.from_numpy(ev))
    feat = np.random.default_rng(2).normal(size=(64, 16)).astype(np.float32)
    fj, ft = jnp.asarray(feat), torch.from_numpy(feat)

    dj = J.edge_distances(fj, gj, ej)
    dt = T.edge_distances(ft, gt, et)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6, atol=1e-6)
    sj = J.edge_similarities(fj, gj, ej, alpha=0.125)
    st = T.edge_similarities(ft, gt, et, alpha=0.125)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=1e-6)
    # matrices from the same values: exact
    np.testing.assert_array_equal(
        T.build_similarity_matrix(torch.from_numpy(np.array(sj)), et, vt, 64).numpy(),
        np.asarray(J.build_similarity_matrix(sj, ej, vj, 64)))
    np.testing.assert_array_equal(
        T.build_distance_matrix(torch.from_numpy(np.array(dj)), et, vt, 64).numpy(),
        np.asarray(J.build_distance_matrix(dj, ej, vj, 64)))

    root = np.arange(64, dtype=np.int32)
    root[10:20] = 3
    prev = counts > 0
    gj, gt = gj._replace(root=jnp.asarray(root)), gt._replace(root=torch.from_numpy(root))
    np.testing.assert_array_equal(
        T.aggregate_cluster_feature(ft, gt, torch.from_numpy(prev)).numpy(),
        np.asarray(J.aggregate_cluster_feature(fj, gj, jnp.asarray(prev))))


@pytest.mark.parametrize("seed,th,budget", [
    (0, 5.0, None),   # eligible edges fit the JAX compaction budget
    (1, 5.0, 64),     # they overflow it: the JAX side scans all edges
    (2, 9.0, None),
])
def test_group_nearby_sequential_matches_jax(seed, th, budget):
    counts, ins, sem, edges, ev, dists = _graph_case(seed)
    gj, gt = _graphs(counts, ins, sem)
    run = jax.jit(lambda g, e, v, d: J.group_nearby_clusters_sequential(
        g, e, v, d, th, compact_budget=budget))
    gj, cj = run(gj, jnp.asarray(edges), jnp.asarray(ev), jnp.asarray(dists))
    gt, ct = T.group_nearby_clusters_sequential(
        gt, torch.from_numpy(edges), torch.from_numpy(ev), torch.from_numpy(dists), th)
    _assert_graph_equal(gj, gt)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert (np.asarray(gj.root) != np.arange(512)).sum() > 100  # merges happened


@pytest.mark.parametrize("seed,th,n_labeled", [
    (0, 5.0, 60), (1, 2.0, 60), (2, 9.0, 120), (3, 5.0, 0), (4, 7.0, 300)])
def test_group_nearby_parallel_matches_jax(seed, th, n_labeled):
    """The parallel-rounds engine equals JAX's exactly, label conflicts
    included; with conflicts its partition differs from the sequential
    engine's, so the test holds the parallel engine and not the other."""
    counts, ins, sem, edges, ev, dists = _graph_case(seed, n_labeled=n_labeled)
    gj, gt = _graphs(counts, ins, sem)
    run = jax.jit(lambda g, e, v, d: J.group_nearby_clusters(g, e, v, d, th))
    gj2, cj = run(gj, jnp.asarray(edges), jnp.asarray(ev), jnp.asarray(dists))
    T.parallel_rounds = 0
    gt2, ct = T.group_nearby_clusters(
        gt, torch.from_numpy(edges), torch.from_numpy(ev), torch.from_numpy(dists), th)
    _assert_graph_equal(gj2, gt2)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert T.parallel_rounds >= 2  # one or more rounds in each of the two passes
    assert (np.asarray(gj2.root) != np.arange(512)).sum() > 100  # merges happened
    gs, _ = T.group_nearby_clusters_sequential(
        gt, torch.from_numpy(edges), torch.from_numpy(ev), torch.from_numpy(dists), th)
    def partition(root):  # each slot's class named by its least member
        root = root.numpy()
        least = np.full(root.shape, root.shape[0])
        np.minimum.at(least, root, np.arange(root.shape[0]))
        return least[root]

    if n_labeled == 0:  # no label, no conflict: the two engines' partitions agree
        np.testing.assert_array_equal(partition(gs.root), partition(gt2.root))
    elif seed in (0, 2, 4):
        assert (partition(gs.root) != partition(gt2.root)).any()


@pytest.mark.parametrize("budget", [None, 8])
def test_absorb_small_clusters_matches_jax(budget):
    counts, ins, sem, edges, ev, _ = _graph_case(3)
    gj, gt = _graphs(counts, ins, sem)
    run = jax.jit(lambda g, e, v: J.absorb_small_clusters(g, e, v, 5,
                                                         compact_budget=budget))
    gj = run(gj, jnp.asarray(edges), jnp.asarray(ev))
    gt = T.absorb_small_clusters(gt, torch.from_numpy(edges), torch.from_numpy(ev), 5)
    _assert_graph_equal(gj, gt)


def test_label_conflict_guard():
    """Two differently labeled segments never merge."""
    gt = T.init_graph(torch.tensor([0] * 10 + [1] * 10, dtype=torch.int32),
                      torch.tensor([0, 1, -1, -1], dtype=torch.int32),
                      torch.tensor([3, 5, -1, -1], dtype=torch.int32), 4)
    g2, conn = T.group_nearby_clusters_sequential(
        gt, torch.tensor([[0, 1], [0, 0]], dtype=torch.int32),
        torch.tensor([True, False]), torch.tensor([0.0, 0.0]), th=10.0)
    assert g2.root.tolist()[:2] == [0, 1]
    assert not bool(conn[0])


def _unlabeled_case(seed, isolated):
    rng = np.random.default_rng(seed)
    s, n = 16, 400
    p2s = rng.integers(0, s, n).astype(np.int32)
    p2s[-10:] = s + 2  # padding points
    ins = np.full(s, -1, np.int32)
    sem = np.full(s, -1, np.int32)
    ins[[0, 5, 11]] = [0, 1, 2]
    sem[[0, 5, 11]] = [3, 9, 4]
    chain = [[i, i + 1] for i in range(s - 1) if i + 1 not in isolated and i not in isolated]
    edges = np.zeros((32, 2), np.int32)
    edges[: len(chain)] = chain
    ev = np.zeros(32, bool)
    ev[: len(chain)] = True
    feat = rng.normal(size=(s, 8)).astype(np.float32)
    points = (rng.normal(size=(n, 3)) * 3).astype(np.float32)
    return p2s, ins, sem, edges, ev, feat, points


@pytest.mark.parametrize("seed,isolated", [(0, (13, 14)), (1, (3, 8, 15)), (2, ())])
def test_group_unlabeled_matches_jax(seed, isolated):
    """Isolated segments have no labeled adjacency path and go through the
    spatial fallback."""
    p2s, ins, sem, edges, ev, feat, points = _unlabeled_case(seed, isolated)
    s = len(ins)
    gj = J.init_graph(jnp.asarray(p2s), jnp.asarray(ins), jnp.asarray(sem), s)
    gt = T.init_graph(torch.from_numpy(p2s), torch.from_numpy(ins), torch.from_numpy(sem), s)
    outj = jax.jit(J.group_unlabeled_clusters)(
        gj, jnp.asarray(feat), jnp.asarray(edges), jnp.asarray(ev),
        jnp.asarray(points), jnp.asarray(p2s))
    outt = T.group_unlabeled_clusters(
        gt, torch.from_numpy(feat), torch.from_numpy(edges), torch.from_numpy(ev),
        torch.from_numpy(points), torch.from_numpy(p2s))
    _assert_graph_equal(outj[0], outt[0])
    np.testing.assert_allclose(outt[1].numpy(), np.asarray(outj[1]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(outt[2].numpy(), np.asarray(outj[2]))
    np.testing.assert_array_equal(outt[3].numpy(), np.asarray(outj[3]))
    act = T.active_mask(outt[0]).numpy()
    assert (outt[0].ins_label.numpy()[act] != -1).all()  # every cluster labeled
