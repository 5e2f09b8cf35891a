"""The port's span-and-counter recorder (seggroup_tpu_torch/utils/profiling.py)
and the spans and counters placed in its layers: the export's split and its
count of natively formatted files, the host's reads of the card, the
grouping's union steps, the profiler's annotations, the prefetcher's
threads, the device plan and the ranks' wait in the all-reduce. On the CPU, but for the last test, which runs a
bench-shaped stage-1 forward and its export on the card with every implicit
synchronisation made an error. No JAX."""

from __future__ import annotations

import os
import shutil
import sys
import threading
import time
from contextlib import nullcontext

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from seggroup_tpu_torch import native
from seggroup_tpu_torch.data.synthetic import BENCH_SCENE, make_synthetic_scene
from seggroup_tpu_torch.device import PhaseClock
from seggroup_tpu_torch.infer import export_scene, infer_scenes
from seggroup_tpu_torch.models.seggroup import SegGroupGNN
from seggroup_tpu_torch.ops import grouping as gr
from seggroup_tpu_torch.utils import profiling
from seggroup_tpu_torch.utils.prefetch import HostPrefetcher

SCENE = dict(num_points=2048, num_slots=64, num_edges=256, num_instances=6,
             segs_per_instance=6)
FILES_A_SCENE = 15


@pytest.fixture(autouse=True)
def unbound():
    """Each test starts and ends with no sink bound."""
    profiling.stop()
    yield
    profiling.stop()


@pytest.fixture(scope="module")
def model():
    return SegGroupGNN(cluster_cap=256, device="cpu", seed=1)


def _scenes(n, **kw):
    return [make_synthetic_scene(seed=s, **{**SCENE, **kw}).to("cpu") for s in range(n)]


def test_unbound_spans_and_counters_add_nothing():
    assert not profiling.bound()
    assert profiling.span("a") is profiling._NULL
    assert profiling.span("b", fence=torch.device("cpu")) is profiling._NULL
    assert PhaseClock(torch.device("cpu"), None)("c") is profiling._NULL
    profiling.count("d", 3)
    with profiling.span("a"):
        pass
    t = torch.arange(4)
    assert profiling.to_host(t) is t
    assert profiling.nonzero(t).tolist() == [[1], [2], [3]]


def test_a_dict_binds_until_another_dict_or_stop():
    first, second = {}, {}
    clock = PhaseClock(None, first)
    with clock("phase"):
        with profiling.span("phase.inner"):
            profiling.count("things", 2)
    # still bound after the call that bound it
    with profiling.span("later"):
        pass
    assert first["count.phase"] == first["count.phase.inner"] == first["count.later"] == 1
    assert first["count.things"] == 2
    assert 0.0 <= first["phase.inner"] <= first["phase"]
    PhaseClock(torch.device("cpu"), second)
    profiling.count("things")
    assert first["count.things"] == 2 and second == {"count.things": 1}
    profiling.stop()
    profiling.count("things")
    assert second == {"count.things": 1}
    # a call handed no dict records no phase, even while bound
    profiling.bind(first)
    with PhaseClock(None, None)("unasked"):
        pass
    assert "unasked" not in first


def test_counts_from_threads_lose_no_update():
    """More threads than cores, switching often: every count and span
    arrives."""
    sink: dict = {}
    profiling.bind(sink)
    n_threads = 2 * (os.cpu_count() or 4)

    def work():
        for _ in range(2000):
            profiling.count("n")
            with profiling.span("s"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sink["count.n"] == sink["count.s"] == 2000 * n_threads


def test_infer_scenes_splits_the_export(model, tmp_path):
    phases: dict = {}
    scenes = _scenes(2)
    infer_scenes(model, scenes, "ins_infer", str(tmp_path), ["a", "b"], phase_seconds=phases)
    assert phases["count.export"] == 2
    assert phases["count.export.format"] == phases["count.export.write"] == 2 * FILES_A_SCENE
    assert 0.0 < phases["export.format"] + phases["export.write"] <= phases["export"]
    assert phases["count.host.read"] > 2 * FILES_A_SCENE
    assert phases["host.read"] > 0.0
    for name in ("grouping", "cluster_knn", "cluster_pointclouds"):
        assert phases[name] > 0.0 and phases[f"count.{name}"] >= 2
    # the files are the labels, one a line
    out = model(scenes[0], mode="ins_infer")
    got = np.loadtxt(tmp_path / "a" / "ins_infer" / "final.sem.txt", dtype=np.int64)
    np.testing.assert_array_equal(got, out.final_sem.numpy())


def _straggler_scene(seed):
    """A scene whose slot 0 is unlabeled and has no edge: no merge reaches
    it, and the spatial fallback absorbs it."""
    sc = make_synthetic_scene(seed=seed, **SCENE)
    e = sc.edges
    sc.edge_valid[(e[:, 0] == 0) | (e[:, 1] == 0)] = False
    sc.weak_ins[0] = sc.weak_sem[0] = -1
    return sc.to("cpu")


def _small_clusters(seed):
    """The sequential grouping with no edge under its threshold on a scene
    of 420 four-point segments: the absorption of small clusters does every
    union."""
    sc = make_synthetic_scene(seed=seed, num_points=2048, num_slots=512, num_edges=2048,
                              num_instances=20, segs_per_instance=21).to("cpu")
    g = gr.init_graph(sc.point2seg, sc.weak_ins, sc.weak_sem, 512)
    edges, ev = gr.normalize_edges(g, sc.edges, sc.edge_valid)
    return lambda: gr.group_nearby_clusters_sequential(
        g, edges, ev, torch.full((edges.shape[0],), 1e9), 1.0)


def _cases(model):
    """(name, run) of work that drives every union loop of the grouping."""
    out = [(f"forward{s}", lambda sc=sc: model(sc, mode="ins_infer"))
           for s, sc in enumerate(_scenes(2))]
    out += [(f"straggler{s}", lambda s=s: model(_straggler_scene(s), mode="ins_infer"))
            for s in range(2)]
    return out + [("small_clusters", _small_clusters(0))]


def test_export_counts_the_files_the_library_formatted(model, tmp_path):
    """One scene's export into a bound dict: "count.export.native" is the
    15 files with the native library and 0 under its numpy fallbacks, and
    the files' bytes are the same."""
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler: the library cannot be built")
    assert native.available(), native.load_error()
    out = model(_scenes(1)[0], mode="ins_infer")
    native_counts, files = [], []
    for root, fallback in (("library", False), ("fallback", True)):
        sink: dict = {}
        PhaseClock(None, sink)
        with native.numpy_fallbacks() if fallback else nullcontext():
            export_scene(str(tmp_path / root), "s", "ins_infer", out)
        profiling.stop()
        assert sink["count.export.format"] == sink["count.export.write"] == FILES_A_SCENE
        native_counts.append(sink.get("count.export.native", 0))
        d = tmp_path / root / "s" / "ins_infer"
        files.append({p.name: p.read_bytes() for p in sorted(d.iterdir())})
    assert native_counts == [FILES_A_SCENE, 0]
    assert len(files[0]) == FILES_A_SCENE and files[0] == files[1]


def test_union_count_equals_the_union_steps(model, monkeypatch):
    """`count.unions`, counted from the lengths the host holds before each
    pass, against a count of the calls of the union step itself, by the
    loop that made them; together the cases run every loop."""
    import inspect

    calls = []
    union = gr._union

    def counted(*args):
        calls.append(inspect.stack()[1].function)
        return union(*args)

    monkeypatch.setattr(gr, "_union", counted)
    loops = set()
    for _, run in _cases(model):
        phases: dict = {}
        calls.clear()
        profiling.bind(phases)
        run()
        assert calls and phases["count.unions"] == len(calls)
        loops |= set(calls)
    assert loops == {"group_nearby_clusters_sequential", "absorb_small_clusters",
                     "group_unlabeled_clusters"}


class _Reads(TorchDispatchMode):
    """Counts the operators that read a tensor's contents to the host: item()
    (bool(), int(), and an index by a 0-d tensor) and nonzero."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_host_read_count_equals_the_reads_the_work_makes(model):
    """`count.host.read` (to_host, nonzero and the union loops' implicit
    reads) against every read the dispatcher sees, in forwards and a
    grouping that drive every union loop (on the CPU an index by a 0-d
    tensor reads it as on the card)."""
    for name, run in _cases(model):
        phases: dict = {}
        profiling.bind(phases)
        with _Reads() as reads:
            run()
        assert phases["count.unions"] > 0, name
        assert phases["count.host.read"] == reads.n, name


def _intervals(prof, name):
    return [(e.time_range.start, e.time_range.end) for e in prof.events() if e.name == name]


def test_spans_are_nested_annotations_of_the_profiler_trace(model, tmp_path):
    """With no dict, under torch.profiler: the export's spans, the grouping
    phase and the host's reads are user annotations of the trace, each
    inside the one it runs in."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        infer_scenes(model, _scenes(1), "ins_infer", str(tmp_path), ["a"])
    assert not profiling.bound()
    user = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
    assert {"export", "export.format", "export.write", "grouping", "cluster_knn",
            "host.read"} <= user
    exports = _intervals(prof, "export")
    groupings = _intervals(prof, "grouping")
    assert len(exports) == 1 and len(groupings) == 4

    def inside(child, parents):
        return any(a <= child[0] and child[1] <= b for a, b in parents)

    for name in ("export.format", "export.write"):
        spans = _intervals(prof, name)
        assert len(spans) == FILES_A_SCENE and all(inside(c, exports) for c in spans)
    reads = _intervals(prof, "host.read")
    assert sum(inside(c, exports) for c in reads) == FILES_A_SCENE
    assert any(inside(c, groupings) for c in reads)


def test_unprofiled_unbound_path_opens_no_region(monkeypatch, model, tmp_path):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or profiling._NULL)
    infer_scenes(model, _scenes(1), "ins_infer", str(tmp_path), ["a"])
    assert opened == []


def test_prefetcher_counts_every_batch_made():
    sink: dict = {}
    profiling.bind(sink)
    made = []
    lock = threading.Lock()

    def factory(step):
        with lock:
            made.append(step)
        return step

    pf = HostPrefetcher(factory, depth=3, workers=2)
    assert [next(pf) for _ in range(50)] == list(range(50))
    pf.close()
    for t in pf._threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in pf._threads)
    assert sink["count.prefetch.make"] == len(made) >= 50
    assert sink["count.prefetch_wait"] == 50
    assert sink["prefetch.make"] >= 0.0 and sink["prefetch_wait"] >= 0.0


def test_prefetch_wait_times_a_slow_factory():
    sink: dict = {}
    profiling.bind(sink)
    pf = HostPrefetcher(lambda step: time.sleep(0.05) or step, depth=1, workers=1)
    for _ in range(4):
        next(pf)
    pf.close()
    pf._threads[0].join(timeout=10)
    assert not pf._threads[0].is_alive()
    assert sink["count.prefetch_wait"] == 4
    # one batch ahead: the consumer waits for most of each batch
    assert sink["prefetch_wait"] >= 0.1
    assert sink["prefetch.make"] / sink["count.prefetch.make"] >= 0.045


def test_batch_on_device_is_the_plan_phase():
    from seggroup_tpu_torch.cli.stage2_train_minkunet import batch_on_device
    from seggroup_tpu_torch.data.voxel_dataset import make_voxel_batch
    from seggroup_tpu_torch.sparse.device_plan import pack_voxel_batch

    rng = np.random.default_rng(0)
    coords = rng.uniform(0, 2, (3000, 3)).astype(np.float32)
    vb = make_voxel_batch([(coords, np.ones_like(coords), rng.integers(0, 20, 3000))], 4096,
                          0.05, rng=rng, augment=False)
    caps = [4096, 2048, 1024, 512, 512]
    batch_on_device(pack_voxel_batch(vb), None, torch.device("cpu"), caps)
    sink: dict = {}
    profiling.bind(sink)
    st, labels, plan = batch_on_device(pack_voxel_batch(vb), None, torch.device("cpu"), caps)
    assert sink["count.plan"] == 1 and sink["plan"] > 0.0
    assert int(st.num) == int(vb.num) and plan


def test_stage1_all_reduce_wait_is_the_slow_ranks_delay():
    """2 gloo ranks, rank 1 sleeping 0.2 s before each step: rank 0 waits
    for it at the barrier, and the wait and the transfer lie inside the
    all-reduce phase. The median step's wait, as other processes on the
    host may stretch one rank's step now and then."""
    from seggroup_tpu_torch.parallel.dp import launch

    from _torch_parallel_ranks import stage1_timed

    steps = 5
    # one small scene on both ranks, so that the sleep is the only difference
    # and other processes stretch a step little
    scene = dict(num_points=1024, num_slots=16, num_edges=64, num_instances=2,
                 segs_per_instance=4)
    ranks = launch(stage1_timed, 2, "cpu", scene, [0, 0], steps, 0.2, threads=1,
                   all_ranks=True)
    for r in ranks:
        assert len(r) == steps
        for d in r:
            assert d["count.all-reduce"] == d["count.all-reduce.wait"] == 1
            assert d["all-reduce.wait"] + d["all-reduce.transfer"] <= d["all-reduce"]
    waits = [[d["all-reduce.wait"] for d in r] for r in ranks]
    assert np.median(waits[0]) >= 0.15
    assert np.median(waits[1]) < np.median(waits[0])


@pytest.mark.cuda
def test_every_sync_of_the_bench_forward_and_export_reads_through_the_recorder(tmp_path):
    """A bench-shaped stage-1 ins_infer forward and its export on the card,
    unbound and bound, with every implicit synchronisation an error: each
    read goes through to_host or nonzero or is counted by its loop
    (implicit_reads)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    model = SegGroupGNN(device=dev, seed=1)
    scenes = [make_synthetic_scene(seed=s, **BENCH_SCENE).to(dev) for s in range(3)]
    infer_scenes(model, scenes[:1], "ins_infer", str(tmp_path), ["warm"])
    torch.cuda.synchronize()
    phases: dict = {}
    torch.cuda.set_sync_debug_mode("error")
    try:
        infer_scenes(model, scenes[1:2], "ins_infer", str(tmp_path), ["unbound"])
        infer_scenes(model, scenes[2:], "ins_infer", str(tmp_path), ["bound"],
                     phase_seconds=phases)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert phases["count.export.format"] == FILES_A_SCENE
    assert phases["count.host.read"] > FILES_A_SCENE and phases["count.unions"] > 0
