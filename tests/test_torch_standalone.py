"""The port stands alone: it imports neither JAX nor the JAX package (nor
its drivers in cli/, nor scipy), and its entry points run on the card
unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "seggroup_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "seggroup_tpu", "cli", "scipy")


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import seggroup_tpu_torch.infer, seggroup_tpu_torch.models.convert\n"
        "import seggroup_tpu_torch.ops.cuda_fps, chip_smoke\n"
        "import seggroup_tpu_torch.cli.stage2_test_semantic\n"
        "import seggroup_tpu_torch.sparse.cuda_subm_conv, seggroup_tpu_torch.sparse.cuda_subm_dw\n"
        "import seggroup_tpu_torch.cli.stage2_train_minkunet, seggroup_tpu_torch.solvers\n"
        "import seggroup_tpu_torch.data.transforms, seggroup_tpu_torch.utils.checkpoint\n"
        "import seggroup_tpu_torch.utils.prefetch, seggroup_tpu_torch.utils.tb\n"
        "import seggroup_tpu_torch.utils.logging, seggroup_tpu_torch.cli.stage1_common\n"
        "import seggroup_tpu_torch.profile_forward\n"
        "import seggroup_tpu_torch.ops.cc, seggroup_tpu_torch.ops.radius_cc\n"
        "import seggroup_tpu_torch.ops.cuda_cc, seggroup_tpu_torch.ops.voxelize\n"
        "import seggroup_tpu_torch.models.pointgroup, seggroup_tpu_torch.eval.instance_ap\n"
        "import seggroup_tpu_torch.cli.stage2_pointgroup_common\n"
        "import seggroup_tpu_torch.cli.stage2_test_pointgroup\n"
        "import seggroup_tpu_torch.cli.stage1_train, seggroup_tpu_torch.cli.stage1_infer\n"
        "import seggroup_tpu_torch.cli.stage1_evaluate, seggroup_tpu_torch.data.scannet\n"
        "import seggroup_tpu_torch.cli.stage2_train_pointgroup, seggroup_tpu_torch.data.pg_wire\n"
        "import seggroup_tpu_torch.ops.iou, seggroup_tpu_torch.models.kpconv\n"
        "import seggroup_tpu_torch.data.potentials, seggroup_tpu_torch.data.ply\n"
        "import seggroup_tpu_torch.cli.stage2_train_kpconv\n"
        "import seggroup_tpu_torch.cli.stage2_test_classification\n"
        "import seggroup_tpu_torch.cli.introspect_kpconv\n"
        "import seggroup_tpu_torch.cli.demo_semantic, seggroup_tpu_torch.data.visualize\n"
        "import seggroup_tpu_torch.models.resnet_sparse, seggroup_tpu_torch.models.crf\n"
        "import seggroup_tpu_torch.native, seggroup_tpu_torch.sparse.merge_join\n"
        "import seggroup_tpu_torch.sparse.plan, seggroup_tpu_torch.sparse.device_plan\n"
        "import seggroup_tpu_torch.data.mesh, seggroup_tpu_torch.cli.prepare_scannet\n"
        "import seggroup_tpu_torch.cli.visualize, seggroup_tpu_torch.cli.plot_convergence\n"
        "import seggroup_tpu_torch.utils.profiling\n"
        "import seggroup_tpu_torch.parallel, seggroup_tpu_torch.parallel.dp\n"
        "import seggroup_tpu_torch.parallel.point_sharding, seggroup_tpu_torch.parallel.dryrun\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax(path):
    """No import statement, and no import by name, reaches JAX or the JAX
    package (`seggroup_tpu`, not `seggroup_tpu_torch`)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", "")) in
              ("import_module", "__import__")):
            names = [node.args[0].value]
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_entry_points_default_to_the_card():
    """Without device=, an entry point runs on CUDA, and raises where there
    is none instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
    from seggroup_tpu_torch.infer import entry
    from seggroup_tpu_torch.models.seggroup import SegGroupGNN

    with pytest.raises(RuntimeError, match="CUDA"):
        entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        SegGroupGNN()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_synthetic_scene(num_points=64, num_slots=8, num_edges=16,
                             num_instances=2, segs_per_instance=2).to()


def test_stage2_entry_points_default_to_the_card():
    """The stage-2 CLI's main() without --device, and MinkUNet without
    device=, run on CUDA and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from seggroup_tpu_torch.cli.stage2_test_semantic import main
    from seggroup_tpu_torch.models.minkunet import make_minkunet

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--synthetic", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_minkunet("Res16UNet14A")


def test_training_driver_defaults_to_the_card(tmp_path, monkeypatch):
    """The training driver without --device runs on CUDA and raises where
    there is none; it does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from seggroup_tpu_torch.cli.stage2_train_minkunet import main

    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--synthetic", "2", "--max_iter", "1"])
    assert not (tmp_path / "checkpoints").exists()


def test_pointgroup_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """The PointGroup CLI without --device, and PointGroup without
    device=, run on CUDA and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from seggroup_tpu_torch.cli.stage2_test_pointgroup import main, make_eval_model
    from seggroup_tpu_torch.models.pointgroup import PointGroup

    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--synthetic", "1"])
    assert not (tmp_path / "checkpoints").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        PointGroup(m=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_eval_model(8, 2048, "cuda")


def test_stage1_drivers_default_to_the_card(tmp_path, monkeypatch):
    """The stage-1 training and inference drivers without --device run on
    CUDA and raise where there is none, before they write anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from seggroup_tpu_torch.cli import stage1_infer, stage1_train

    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        stage1_train.main(["--synthetic", "1", "--epochs", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        stage1_infer.main(["--synthetic", "1", "--ins_infer"])
    assert not (tmp_path / "checkpoints").exists()


def test_pointgroup_training_driver_defaults_to_the_card(tmp_path, monkeypatch):
    """The PointGroup training driver without --device runs on CUDA and
    raises where there is none, before it writes anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from seggroup_tpu_torch.cli import stage2_train_pointgroup

    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        stage2_train_pointgroup.main(["--synthetic", "1", "--steps", "1"])
    assert not (tmp_path / "checkpoints").exists()


@pytest.mark.parametrize("driver,argv", [
    ("stage2_train_kpconv", ["--synthetic", "1", "--steps", "1"]),
    ("stage2_test_classification", ["--synthetic", "2"]),
    ("introspect_kpconv", ["--synthetic", "1", "--mode", "erf"])])
def test_kpconv_drivers_default_to_the_card(driver, argv, tmp_path, monkeypatch):
    """The KPConv training, classification and introspection drivers
    without --device run on CUDA and raise where there is none, before
    they write anything; KPCNN without device= too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import importlib

    from seggroup_tpu_torch.models.kpconv import KPCNN

    main = importlib.import_module(f"seggroup_tpu_torch.cli.{driver}").main
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
    assert not any(tmp_path.iterdir())
    with pytest.raises(RuntimeError, match="CUDA"):
        KPCNN(num_classes=6)


def test_registry_imports_no_model_until_asked():
    """Importing the registry imports no model module; `get_model` imports
    the named model's."""
    code = ("import sys\n"
            "import seggroup_tpu_torch.models as R\n"
            "assert not [m for m in sys.modules if m.startswith('seggroup_tpu_torch.models.')]\n"
            "R.get_model('Res16UNet14A', device='cpu')\n"
            "assert 'seggroup_tpu_torch.models.seggroup' not in sys.modules\n"
            "assert 'seggroup_tpu_torch.models.pointgroup' not in sys.modules\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_demo_and_registry_default_to_the_card(tmp_path, monkeypatch):
    """The demo without --device runs on CUDA and raises where there is
    none, before it writes anything; the registry's models, the sparse
    ResNet and KPCNN heads and the CRF wrapper without device= too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from seggroup_tpu_torch.cli.demo_semantic import main
    from seggroup_tpu_torch.models import get_model
    from seggroup_tpu_torch.models.resnet_sparse import KPCNN, SparseResNet

    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--synthetic"])
    assert not any(tmp_path.iterdir())
    for name in ("MinkUNetHyper14INBN", "STResTesseract16UNet18A", "ResUNet18INBN",
                 "BilateralCRF-Res16UNet14A", "ResNet14"):
        with pytest.raises(RuntimeError, match="CUDA"):
            get_model(name)
    for make in (SparseResNet, KPCNN):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
