"""The port's raw-ScanNet preparation and the last host drivers against the
JAX package on the CPU, on small synthetic raw scenes the tests write
(tests/test_prepare_scannet.py's 500-vertex grid mesh with its segs.json,
aggregation.json and label TSV): `read_scene_raw` (the scene0217_00
duplicated-segments case too), `prepare_scene` in every label style the
JAX CLI offers and through its resampling, unmap and segment-overflow
branches, `rasterize_mesh`, and `prepare_scannet`'s npz files (process
pool and rasterisation included), all exactly equal; `visualize` writes
the JAX package's PLY bytes, `plot_convergence` its CSV and PNG."""

import json
import os

import numpy as np
import pytest

from cli import prepare_scannet as JCLI
from seggroup_tpu.data import mesh as JM
from seggroup_tpu.data import scannet as JS
from seggroup_tpu.data import visualize as JV
from seggroup_tpu_torch.cli import plot_convergence, prepare_scannet, visualize
from seggroup_tpu_torch.data import mesh as TM
from seggroup_tpu_torch.data import scannet as TS

from test_prepare_scannet import make_raw_scene, write_tsv


@pytest.fixture(scope="module")
def raw_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(0)
    make_raw_scene(str(root / "scans"), "scene0000_00", rng)
    make_raw_scene(str(root / "scans"), "scene0217_00", rng, duplicate_segs=True)
    write_tsv(str(root / "labels.tsv"))
    manual = root / "manual"
    manual.mkdir()
    for scene in ("scene0000_00", "scene0217_00"):
        (manual / f"{scene}.json").write_text(json.dumps({"1": [100, 104], "2": [107]}))
    return root


def _raw(root, scene, pkg):
    return pkg.read_scene_raw(str(root / "scans"), scene, str(root / "labels.tsv"))


def _equal_dicts(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("scene", ["scene0000_00", "scene0217_00"])
def test_read_scene_raw_equals_jax(raw_dir, scene):
    got, want = _raw(raw_dir, scene, TS), _raw(raw_dir, scene, JS)
    _equal_dicts(got, want)
    assert len(got["seg_labels"]) == len(got["vertices"]) == 500
    assert set(np.unique(got["real_sem"])) == {1, 5, 6, 7}


@pytest.mark.parametrize("case", ["maxseg", "mainseg", "rand", "manual", "subsample",
                                  "segment_overflow"])
def test_prepare_scene_equals_jax(raw_dir, case):
    raw_t, raw_j = _raw(raw_dir, "scene0000_00", TS), _raw(raw_dir, "scene0000_00", JS)
    style = case if case in ("maxseg", "mainseg", "rand", "manual") else "maxseg"
    kw = dict(style=style, seed=3)
    if style == "manual":
        kw["manual"] = {"1": [100, 104], "2": [107]}
    if style == "mainseg":
        kw["main_num"] = 3
    n_points, max_segments = {"subsample": (300, 64), "segment_overflow": (1024, 8)}.get(
        case, (2048, 64))
    got = TS.prepare_scene(raw_t, TS.PrepConfig(num_points=n_points, max_segments=max_segments,
                                                max_edges=512), **kw)
    want = JS.prepare_scene(raw_j, JS.PrepConfig(num_points=n_points, max_segments=max_segments,
                                                 max_edges=512), **kw)
    _equal_dicts(got, want)
    assert (got["weak_ins"] >= 0).sum() >= 2
    if case == "subsample":  # fewer points than vertices: the nearest-neighbour unmap
        assert len(got["mapping"]) == 300 and not np.array_equal(got["unmap"], np.arange(500))


@pytest.mark.parametrize("dl", [0.03, 0.07, 1.0])
def test_rasterize_mesh_equals_jax(raw_dir, dl):
    raw = _raw(raw_dir, "scene0000_00", TS)
    args = (raw["vertices"][:, :3], raw["faces"], dl)
    got = TM.rasterize_mesh(*args, features=raw["vertices"][:, 3:])
    want = JM.rasterize_mesh(*args, features=raw["vertices"][:, 3:])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def _prepare_args(root, out, style, workers, extra=()):
    return ["--scans_dir", str(root / "scans"), "--tsv", str(root / "labels.tsv"),
            "--out", str(out), "--label_style", style, "--num_points", "2048",
            "--max_segments", "64", "--max_edges", "512", "--workers", str(workers),
            "--manual_dir", str(root / "manual"), *extra]


@pytest.mark.parametrize("style,workers,rasterize", [("maxseg", 1, 0.0), ("manual", 2, 0.0),
                                                     ("rand", 1, 0.05)])
def test_prepare_scannet_npz_equals_jax(raw_dir, tmp_path, style, workers, rasterize):
    results = prepare_scannet.main(_prepare_args(raw_dir, tmp_path / "port", style, workers,
                                                 ["--rasterize_dl", str(rasterize)]))
    assert [r[2] for r in results] == [None, None]
    jdir = tmp_path / "jax" / style
    jdir.mkdir(parents=True)
    for scene in ("scene0000_00", "scene0217_00"):
        err = JCLI.prep_one((str(raw_dir / "scans"), str(raw_dir / "labels.tsv"), scene,
                             str(jdir), style, str(raw_dir / "manual"), 2048, 64, 512, 0,
                             rasterize))[2]
        assert err is None
        got = np.load(tmp_path / "port" / style / f"{scene}.npz")
        want = np.load(jdir / f"{scene}.npz")
        got, want = {k: got[k] for k in got.files}, {k: want[k] for k in want.files}
        if rasterize:
            _near_ties_only(raw_dir, scene, rasterize, got, want)
        _equal_dicts(got, want)
    # the stage-1 reader takes the port's file
    scene, extras = TS.load_scene_npz(str(tmp_path / "port" / style / "scene0000_00.npz"))
    assert scene.points.shape == (2048, 6) and "unmap" in extras


def _near_ties_only(raw_dir, scene, dl, got, want):
    """A rasterised scene has more points than the budget, so `unmap` takes
    the nearest-neighbour search, whose squared distances the JAX library's
    build (-march=native) may round through FMA and the port's does not:
    the two may pick different points of one near-tie. Checks that every
    difference is such a tie (float64 distances within float32 rounding)
    and then takes the JAX side's choice."""
    raw = TS.read_scene_raw(str(raw_dir / "scans"), scene, str(raw_dir / "labels.tsv"))
    pts = TM.rasterize_mesh(raw["vertices"][:, :3], raw["faces"], dl)[0].astype(np.float64)
    resampled = got["points"][:, :3].astype(np.float64)
    diff = np.nonzero(got["unmap"] != want["unmap"])[0]
    assert len(diff) <= max(1, len(pts) // 1000)
    for i in diff:
        d_got = ((resampled[got["unmap"][i]] - pts[i]) ** 2).sum()
        d_want = ((resampled[want["unmap"][i]] - pts[i]) ** 2).sum()
        assert abs(d_got - d_want) <= 4 * np.finfo(np.float32).eps * d_want, (i, d_got, d_want)
    got["unmap"] = want["unmap"]


def test_visualize_writes_the_jax_plys(raw_dir, tmp_path):
    mesh = raw_dir / "scans" / "scene0000_00" / "scene0000_00_vh_clean_2.ply"
    rng = np.random.default_rng(1)
    sem = tmp_path / "final.sem.txt"
    np.savetxt(sem, rng.integers(0, 41, 500), fmt="%d")
    visualize.main(["--mesh", str(mesh), "--labels", str(sem), "--out",
                    str(tmp_path / "port.ply")])
    JV.visualize_labels(str(mesh), np.loadtxt(sem, dtype=np.int64), str(tmp_path / "jax.ply"))
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()

    proc = tmp_path / "ins_infer"
    proc.mkdir()
    for layer in range(2):
        np.savetxt(proc / f"layer_{layer}.seg.txt", rng.integers(-1, 30, 500), fmt="%d")
    np.savetxt(proc / "layer_0.ins.txt", rng.integers(-1, 5, 500), fmt="%d")
    visualize.main(["--mesh", str(mesh), "--process_dir", str(proc), "--out",
                    str(tmp_path / "proc")])
    JV.visualize_grouping_process(str(mesh), np.loadtxt(proc / "layer_0.ins.txt", dtype=np.int64),
                                  np.loadtxt(proc / "layer_0.seg.txt", dtype=np.int64),
                                  str(tmp_path / "jax_proc0.ply"), shuffle=False)
    assert sorted(os.listdir(tmp_path / "proc")) == ["layer_0.ply", "layer_1.ply"]
    assert ((tmp_path / "proc" / "layer_0.ply").read_bytes()
            == (tmp_path / "jax_proc0.ply").read_bytes())


def test_plot_convergence_writes_csv_and_png(tmp_path, capsys):
    log = tmp_path / "minkunet.log"
    log.write_text("".join(f"iter {i}/30  loss {2.0 / i:.4f}  running mIoU {i:.2f}%\n"
                           for i in range(1, 31)))
    plot_convergence.main(["--log", str(log), "--out", str(tmp_path / "c.csv"),
                           "--png", str(tmp_path / "c.png")])
    out = capsys.readouterr().out
    assert "loss" in out and "running_miou" in out
    rows = (tmp_path / "c.csv").read_text().splitlines()
    assert rows[0] == "step,loss,running_miou" and len(rows) == 31
    assert (tmp_path / "c.png").stat().st_size > 1000
