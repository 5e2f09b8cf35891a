"""Padded segment-graph grouping engine (seggroup_tpu/ops/grouping.py).

Segments live in S slots; `root: (S,)` maps every slot to its current root
slot and is kept fully compressed, so find() is one gather. Edges live in E
slots with a validity mask, sorted by (root_lo, root_hi). A union is a
masked vector update, and each sequential pass of the reference
(`lax.scan` / `lax.while_loop` on the JAX side) is a Python loop of such
updates here. Each union step indexes by 0-d card tensors, which
Tensor.__getitem__ reads to the host by itself (`_UNION_READS` a step);
beside those the host reads one value per pass or branch. The reads go
through utils/profiling.py (`to_host`, `nonzero`; the union loops' own are
counted by `implicit_reads`), which, where bound, also counts the union
steps each pass launches ("count.unions", from the lengths the host holds).

Where a JAX scan step is a no-op for a reason fixed before the scan starts
(an edge that is not eligible, a slot that is not an unlabeled live root),
the loop here skips it; the result is the same state. This is the JAX
side's own eligible-edge compaction carried to its end, so its
compaction-overflow branches (full scans) give the same result too.

The parallel-rounds engine (`group_nearby_clusters`) runs its two
`lax.while_loop`s as Python loops of whole-array steps, with one host read
per iteration for the loop condition. On the bench scenes (150,528 points,
512 slots, 4,096 edges; random weights) a grouping pass averaged 1.5
rounds and 2.04 CC iterations (chip_smoke.py); `parallel_rounds` and
`parallel_cc_iterations` count them.

Weak-label algebra (model.py:188-190 of the reference): labels are ints with
-1 = unlabeled; on a merge of r1 into r2 with differing ins labels the
surviving label is `-l1*l2`."""

from __future__ import annotations

from typing import NamedTuple

import torch

from seggroup_tpu_torch.ops.fma import dot_fma
from seggroup_tpu_torch.ops.segment_ops import segment_max, segment_mean, segment_min, segment_sum
from seggroup_tpu_torch.utils import profiling

__all__ = [
    "SegGraph",
    "init_graph",
    "normalize_edges",
    "group_nearby_clusters",
    "group_nearby_clusters_sequential",
    "absorb_small_clusters",
    "group_unlabeled_clusters",
    "aggregate_cluster_feature",
    "edge_distances",
    "edge_similarities",
    "build_similarity_matrix",
    "build_distance_matrix",
    "active_mask",
]

INVALID_KEY = torch.iinfo(torch.int32).max
DIST_DEFAULT = 1000.0  # reference build_distance_matrix fill (model.py:313)

# attach rounds and CC iterations of the parallel-rounds engine since the
# caller last set them to 0
parallel_rounds = 0
parallel_cc_iterations = 0


class SegGraph(NamedTuple):
    """Fixed-shape disjoint-set over S segment slots."""

    root: torch.Tensor       # (S,) int32, fully compressed
    point_num: torch.Tensor  # (S,) int32, valid at root slots
    ins_label: torch.Tensor  # (S,) int32, weak instance label at roots, -1 = none
    sem_label: torch.Tensor  # (S,) int32, weak semantic label at roots
    seg_valid: torch.Tensor  # (S,) bool, slot holds a real segment

    @property
    def num_slots(self) -> int:
        return self.root.shape[0]


def _slots(g: SegGraph) -> torch.Tensor:
    return torch.arange(g.num_slots, dtype=torch.int32, device=g.root.device)


def active_mask(g: SegGraph) -> torch.Tensor:
    """(S,) bool: slot is a live cluster root."""
    return g.seg_valid & (g.root == _slots(g))


def init_graph(point2seg: torch.Tensor, weak_ins: torch.Tensor,
               weak_sem: torch.Tensor, num_slots: int) -> SegGraph:
    """Initial graph from per-point segment ids (>= num_slots marks padding)
    and per-segment weak labels (-1 unlabeled)."""
    counts = segment_sum(torch.ones_like(point2seg, dtype=torch.int32),
                         point2seg, num_slots)
    return SegGraph(
        root=torch.arange(num_slots, dtype=torch.int32, device=point2seg.device),
        point_num=counts,
        ins_label=weak_ins.to(torch.int32),
        sem_label=weak_sem.to(torch.int32),
        seg_valid=counts > 0,
    )


# ---------------------------------------------------------------------------
# unions
# ---------------------------------------------------------------------------

# reads of the card that Tensor.__getitem__ makes by itself, as an index by a
# 0-d card tensor calls its .item(): _union's five (ins_label, point_num and
# sem_label at r1; ins_label and sem_label at r2), counted by the loops that
# call it (profiling.implicit_reads)
_UNION_READS = 5


def _union(g: SegGraph, r1: torch.Tensor, r2: torch.Tensor,
           do: torch.Tensor) -> SegGraph:
    """Merge root r1 into root r2 where `do` (0-d bool tensor). r1 and r2
    are 0-d int tensors holding roots. Applies the label-conflict guard."""
    i1, i2 = g.ins_label[r1], g.ins_label[r2]
    blocked = (i1 != -1) & (i2 != -1) & (i1 != i2)
    do = do & (r1 != r2) & ~blocked

    at_r2 = (r2[None],)
    root = torch.where(do & (g.root == r1), r2, g.root)
    pn = g.point_num.index_put(
        at_r2, torch.where(do, g.point_num[r1], 0)[None], accumulate=True)
    s1, s2 = g.sem_label[r1], g.sem_label[r2]
    differ = i1 != i2
    new_ins = torch.where(differ, -i1 * i2, i2)
    new_sem = torch.where(differ, -s1 * s2, s2)
    ins = g.ins_label.index_put(at_r2, torch.where(do, new_ins, i2)[None])
    sem = g.sem_label.index_put(at_r2, torch.where(do, new_sem, s2)[None])
    return SegGraph(root, pn, ins, sem, g.seg_valid)


# ---------------------------------------------------------------------------
# edge bookkeeping
# ---------------------------------------------------------------------------


def normalize_edges(g: SegGraph, edges: torch.Tensor,
                    edge_valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Map edge endpoints to live roots, drop self-edges, dedup, and sort
    by (lo, hi). Same E slots out, valid prefix."""
    s = g.num_slots
    e0 = g.root[edges[:, 0].clamp(0, s - 1)]
    e1 = g.root[edges[:, 1].clamp(0, s - 1)]
    lo = torch.minimum(e0, e1)
    hi = torch.maximum(e0, e1)
    valid = edge_valid & (lo != hi)
    key = torch.sort(torch.where(valid, lo * s + hi, INVALID_KEY)).values
    dup = torch.cat([key.new_zeros(1, dtype=torch.bool), key[1:] == key[:-1]])
    valid = (key != INVALID_KEY) & ~dup
    lo_s = torch.where(valid, key // s, 0)
    hi_s = torch.where(valid, key % s, 0)
    return torch.stack([lo_s, hi_s], dim=1).to(torch.int32), valid


def edge_distances(feat: torch.Tensor, g: SegGraph, edges: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """L2 feature distance between edge endpoint clusters (features live at
    root slots); eps inside the norm as torch pairwise_distance adds it."""
    d = feat[edges[:, 0]] - feat[edges[:, 1]] + eps
    return torch.sqrt(torch.sum(d * d, dim=-1))


def edge_similarities(feat: torch.Tensor, g: SegGraph, edges: torch.Tensor,
                      alpha: float = 1.0) -> torch.Tensor:
    """exp(-alpha * dist)."""
    return torch.exp(-edge_distances(feat, g, edges) * alpha)


def _symmetric_fill(m: torch.Tensor, vals: torch.Tensor, edges: torch.Tensor,
                    edge_valid: torch.Tensor, invalid_val: float) -> torch.Tensor:
    # invalid edges write `invalid_val` into cell (0, 0), which already
    # holds it; valid edges are deduplicated, so no cell gets two values
    r = torch.where(edge_valid, edges[:, 0], 0)
    c = torch.where(edge_valid, edges[:, 1], 0)
    vals = torch.where(edge_valid, vals, invalid_val)
    m[r, c] = vals
    m[c, r] = vals
    return m


def build_similarity_matrix(sims: torch.Tensor, edges: torch.Tensor,
                            edge_valid: torch.Tensor, num_slots: int) -> torch.Tensor:
    """(S, S) symmetric similarity matrix with unit diagonal. Inactive slots
    keep identity rows, so the GCN's row normalization leaves them inert."""
    m = torch.eye(num_slots, dtype=sims.dtype, device=sims.device)
    return _symmetric_fill(m, sims, edges, edge_valid, 1.0)


def build_distance_matrix(dists: torch.Tensor, edges: torch.Tensor,
                          edge_valid: torch.Tensor, num_slots: int) -> torch.Tensor:
    """(S, S) distance matrix, default DIST_DEFAULT."""
    m = torch.full((num_slots, num_slots), DIST_DEFAULT, dtype=torch.float32,
                   device=dists.device)
    return _symmetric_fill(m, dists.to(torch.float32), edges, edge_valid,
                           DIST_DEFAULT)


def aggregate_cluster_feature(feat: torch.Tensor, g: SegGraph,
                              prev_active: torch.Tensor) -> torch.Tensor:
    """Max-pool features of previous-layer clusters into their new roots.
    `prev_active` marks the slots that held features before the merge."""
    s = g.num_slots
    return segment_max(feat, torch.where(prev_active, g.root, s), s)


# ---------------------------------------------------------------------------
# grouping passes
# ---------------------------------------------------------------------------


def _scatter_min(s: int, index: torch.Tensor, values: torch.Tensor, fill: int) -> torch.Tensor:
    """(s,) int32 filled with `fill`, then the min of `values` at `index`
    (JAX's deterministic `.at[index].min(values)`)."""
    out = torch.full((s,), fill, dtype=torch.int32, device=index.device)
    return out.scatter_reduce_(0, index.long(), values.to(torch.int32), "amin",
                               include_self=True)


def _constrained_merge_rounds(g: SegGraph, edges: torch.Tensor, eligible_fn) -> SegGraph:
    """Parallel label-constrained union of the edges `eligible_fn` selects
    (seggroup_tpu/ops/grouping.py `_constrained_merge_rounds`), in rounds:

      * CC phase: eligible edges whose endpoints are both unlabeled or share
        a label are contracted by min-root propagation to a fixpoint, with
        one pointer jump per iteration;
      * attach phase: each unlabeled root merges into the labeled root of
        its lowest-index eligible edge, one attachment per root per round.

    Rounds repeat until an attach phase changes nothing. Inactive edges
    scatter the largest value into the dump slot s - 1, which a min leaves
    as it was. `eligible_fn(graph, root_e0, root_e1) -> bool mask` sees the
    current roots and point counts."""
    global parallel_rounds, parallel_cc_iterations
    s = g.num_slots
    dev = g.root.device
    e0, e1 = edges[:, 0].long(), edges[:, 1].long()
    base_counts = torch.where(g.seg_valid, g.point_num, 0)
    slots = _slots(g)
    eidx = torch.arange(edges.shape[0], dtype=torch.int32, device=dev)
    ins = g.ins_label

    def recount(root):
        return segment_sum(base_counts, torch.where(g.seg_valid, root, s), s).to(
            g.point_num.dtype)

    def eligible(root):
        r0, r1 = root[e0], root[e1]
        g2 = g._replace(root=root, point_num=recount(root))
        return r0, r1, ins[r0], ins[r1], eligible_fn(g2, r0, r1) & (r0 != r1)

    def cc_contract(root):
        global parallel_cc_iterations
        while True:
            parallel_cc_iterations += 1
            r0, r1, l0, l1, elig = eligible(root)
            commute = elig & (((l0 == -1) & (l1 == -1)) | (l0 == l1))
            tgt = torch.where(commute, torch.minimum(r0, r1), s)
            prop = _scatter_min(s, torch.where(commute, r0, s - 1), tgt, s)
            prop = prop.scatter_reduce_(0, torch.where(commute, r1, s - 1).long(), tgt,
                                        "amin", include_self=True)
            new = torch.minimum(root, prop[root.long()])
            new = torch.minimum(new, new[new.long()])  # pointer jumping
            if not bool(profiling.to_host(torch.any(new != root))):
                return new
            root = new

    def attach(root):
        r0, r1, l0, l1, elig = eligible(root)
        att = elig & ((l0 == -1) ^ (l1 == -1))
        u = torch.where(l0 == -1, r0, r1)  # unlabeled side
        lab = torch.where(l0 == -1, r1, r0)  # labeled side
        big = edges.shape[0]
        choice = _scatter_min(s, torch.where(att, u, s - 1), torch.where(att, eidx, big), big)
        has = choice < big
        mapping = torch.where(has, lab[torch.clamp(choice, max=big - 1).long()], slots)
        new = mapping[root.long()]
        return new, bool(profiling.to_host(torch.any(new != root)))

    root = g.root
    changed = True
    while changed:
        parallel_rounds += 1
        root, changed = attach(cc_contract(root))
    # a root's labels never change here: labeled roots absorb, unlabeled
    # roots join labeled ones or stay unlabeled
    return g._replace(root=root, point_num=recount(root))


def group_nearby_clusters(
    g: SegGraph,
    edges: torch.Tensor,
    edge_valid: torch.Tensor,
    dists: torch.Tensor,
    th: float,
    min_points: int = 5,
) -> tuple[SegGraph, torch.Tensor]:
    """Threshold-merge adjacent clusters, then force-absorb clusters of fewer
    than `min_points` points, in parallel rounds (`_constrained_merge_rounds`).
    Its partition equals the sequential engine's wherever a connected
    component holds at most one distinct label; with label conflicts it
    splits components as JAX's parallel engine does, which this function
    reproduces exactly. Returns (graph, connected mask over edges)."""
    passing = edge_valid & (dists <= th)
    g = _constrained_merge_rounds(g, edges, lambda gg, r0, r1: passing)

    def small_elig(gg, r0, r1):
        return edge_valid & ((gg.point_num[r0] < min_points)
                             | (gg.point_num[r1] < min_points))

    g = _constrained_merge_rounds(g, edges, small_elig)
    connected = edge_valid & (g.root[edges[:, 0]] == g.root[edges[:, 1]])
    return g, connected


def group_nearby_clusters_sequential(
    g: SegGraph,
    edges: torch.Tensor,
    edge_valid: torch.Tensor,
    dists: torch.Tensor,
    th: float,
    min_points: int = 5,
) -> tuple[SegGraph, torch.Tensor]:
    """Sequential-order threshold merge over the edge list, then
    small-cluster absorption (reference model.py:218-258).

    Eligibility `edge_valid & (dist <= th)` does not depend on the merge
    state, so the scan visits exactly the eligible edges, in edge order.
    Returns (graph, connected_mask over edges)."""
    eligible = edge_valid & (dists <= th)
    always = torch.ones((), dtype=torch.bool, device=edges.device)
    todo = profiling.nonzero(eligible)[:, 0]
    profiling.count("unions", todo.shape[0])
    with profiling.implicit_reads(_UNION_READS * todo.shape[0], todo):
        for e in edges[todo]:
            r = g.root[e]
            g = _union(g, r[0], r[1], always)
    g = absorb_small_clusters(g, edges, edge_valid, min_points)
    connected = edge_valid & (g.root[edges[:, 0]] == g.root[edges[:, 1]])
    return g, connected


def absorb_small_clusters(g: SegGraph, edges: torch.Tensor,
                          edge_valid: torch.Tensor,
                          min_points: int = 5) -> SegGraph:
    """Repeatedly merge across edges touching a cluster with < min_points
    points until a full pass makes no merge.

    Cluster sizes only grow, and a cluster that is small at any time
    consists solely of clusters small at the start, so only edges with a
    small endpoint at the start can ever merge: the passes visit those, in
    edge order. A pass merged iff the root array changed."""
    s = g.num_slots
    r0 = g.root[edges[:, 0].clamp(0, s - 1)]
    r1 = g.root[edges[:, 1].clamp(0, s - 1)]
    touch = edge_valid & ((g.point_num[r0] < min_points)
                          | (g.point_num[r1] < min_points))
    touching = edges[profiling.nonzero(touch)[:, 0]]
    merged = touching.shape[0] > 0
    while merged:
        before = g.root
        profiling.count("unions", touching.shape[0])
        with profiling.implicit_reads(_UNION_READS * touching.shape[0], touching):
            for e in touching:
                r = g.root[e]
                small = torch.any(g.point_num[r] < min_points)
                g = _union(g, r[0], r[1], small)
        merged = bool(profiling.to_host(torch.any(g.root != before)))
    return g


def group_unlabeled_clusters(
    g: SegGraph,
    feat: torch.Tensor,
    edges: torch.Tensor,
    edge_valid: torch.Tensor,
    points: torch.Tensor,
    point2seg: torch.Tensor,
) -> tuple[SegGraph, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorb unlabeled clusters: merge each unlabeled cluster into its
    feature-nearest adjacent cluster until the cluster count stops
    shrinking, then spatially absorb stragglers into the nearest labeled
    cluster. Returns (graph, feat, edges, edge_valid).

    A live root's label never returns to -1, so each pass visits only the
    slots that are unlabeled live roots when it starts."""
    s = g.num_slots
    feat = feat.detach()
    points = points.detach()
    slots = _slots(g)

    while True:
        act = active_mask(g)
        before = int(profiling.to_host(act.sum()))
        dists = edge_distances(feat, g, edges)
        dmat = build_distance_matrix(dists, edges, edge_valid, s)
        # emulate compact-space argmin: inactive columns lose to active
        # DIST_DEFAULT columns; ties resolve to the smallest slot
        col_pen = torch.where(act, 0.0, 1e9)[None, :]
        target = torch.argmin(dmat + col_pen, dim=-1)
        todo = profiling.nonzero(act & (g.ins_label == -1))[:, 0]
        profiling.count("unions", todo.shape[0])
        # and four of its own a slot: g.root[slot], target[slot], g.root at
        # it, g.ins_label[r1]
        with profiling.implicit_reads((_UNION_READS + 4) * todo.shape[0], todo):
            for slot in todo:
                r1 = g.root[slot]
                g = _union(g, r1, g.root[target[slot]], g.ins_label[r1] == -1)
        feat = aggregate_cluster_feature(feat, g, act)
        edges, edge_valid = normalize_edges(g, edges, edge_valid)
        # stop when a full round leaves the cluster count unchanged
        if int(profiling.to_host(active_mask(g).sum())) == before:
            break

    # ---- spatial fallback for clusters with no labeled adjacency path ----
    act = active_mask(g)
    pt_valid = point2seg < s
    point2root = torch.where(pt_valid, g.root[point2seg.clamp(0, s - 1)], s)
    centroid = segment_mean(points, point2root, s)  # (S, 3)

    # D[i, c] = min over points p of cluster c of ||centroid_i - p||^2, in
    # point blocks to bound memory, with the JAX side's rounding (ops/fma.py)
    cc = dot_fma(centroid, centroid)[:, None]
    dmat_sp = torch.full((s, s), 1e30, device=points.device)
    blk = 8192
    for p0 in range(0, points.shape[0], blk):
        p = points[p0:p0 + blk]
        d = (cc - 2.0 * dot_fma(centroid[:, None, :], p[None, :, :])
             + dot_fma(p, p)[None, :])
        upd = segment_min(d.T, point2root[p0:p0 + blk], s, fill_value=1e30).T
        dmat_sp = torch.minimum(dmat_sp, upd)

    straggler = profiling.nonzero(act & (g.ins_label == -1))[:, 0]
    profiling.count("unions", straggler.shape[0])
    # and five of its own a straggler: g.root[slot], dmat_sp[slot],
    # g.ins_label[r1], d[j], g.root[j]
    with profiling.implicit_reads((_UNION_READS + 5) * straggler.shape[0], straggler):
        for slot in straggler:
            r1 = g.root[slot]
            # nearest snapshot cluster whose live root is labeled
            eligible = act & (g.ins_label[g.root] != -1) & (slots != slot)
            d = torch.where(eligible, dmat_sp[slot], 1e30)
            j = torch.argmin(d)
            ok = (g.ins_label[r1] == -1) & (d[j] < 1e30)
            g = _union(g, r1, g.root[j], ok)
    if straggler.shape[0]:
        feat = aggregate_cluster_feature(feat, g, act)
    edges, edge_valid = normalize_edges(g, edges, edge_valid)
    return g, feat, edges, edge_valid
