"""Stage-1 pseudo-label inference entry points.

`entry` and `dryrun_multichip` are the port's counterparts of
__graft_entry__.entry() and __graft_entry__.dryrun_multichip(n); `infer_scenes`
runs the stage-1 forward per scene and writes the reference's label-file
layout (cli/stage1_common.py export_labels_txt / export_scene):
results/<scene>/<mode>/{final,layer_L}.{sem,ins,seg}.txt."""

from __future__ import annotations

import os
from collections.abc import Sequence

import numpy as np
import torch

from seggroup_tpu_torch import native
from seggroup_tpu_torch.data.synthetic import make_synthetic_scene
from seggroup_tpu_torch.device import PhaseClock, resolve_device
from seggroup_tpu_torch.models.seggroup import SegGroupGNN, Stage1Output
from seggroup_tpu_torch.types import Scene
from seggroup_tpu_torch.utils import profiling


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args): the flagship stage-1 forward in ins_infer mode on
    a small synthetic scene, on the card unless device='cpu'."""
    dev = resolve_device(device)
    model = SegGroupGNN(cluster_cap=256, device=dev)
    scene = make_synthetic_scene(
        seed=0, num_points=2048, num_slots=64, num_edges=256,
        num_instances=4, segs_per_instance=4).to(dev)

    def fn(model, scene):
        out = model(scene, mode="ins_infer")
        return out.loss_sum, out.final_sem, out.iou_sem

    return fn, (model, scene)


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda",
                     backend: str | None = None) -> list[dict]:
    """One step of each data-parallel and point-sharded path on tiny shapes
    in `n_devices` ranks (parallel/dryrun.py has the seven checks), one
    `launch`; prints one line a check, in the JAX function's order and
    wording, and returns every rank's dryrun_rank result. "cuda" puts rank
    r on card r over NCCL (fewer cards than ranks raise); "cuda:i" puts
    every rank on card i over gloo (NCCL refuses two ranks on one card);
    "cpu" runs gloo ranks on the CPU. `backend` overrides that choice. A
    check that fails in a rank raises here."""
    from seggroup_tpu_torch.parallel.dp import launch, resolve_num_devices
    from seggroup_tpu_torch.parallel.dryrun import dryrun_inputs, dryrun_rank

    dev = resolve_device(device)
    if dev.index is None:
        resolve_num_devices(n_devices, dev)
    elif backend is None:
        backend = "gloo"
    ranks = launch(dryrun_rank, n_devices, dev, dryrun_inputs(n_devices), backend=backend,
                   all_ranks=True)
    for line in ranks[0]["lines"]:
        print(line, flush=True)
    return ranks


def export_labels_txt(out_dir: str, stem: str, labels: np.ndarray) -> None:
    """One label a line into out_dir/<stem>.txt; the recorder's spans
    "export.format" (the labels into text, `native.format_int_lines`) and
    "export.write" (the file), and its count "export.native" when the
    native library formatted the file."""
    with profiling.span("export.format"):
        body = native.format_int_lines(labels)
    if native.available():
        profiling.count("export.native")
    with profiling.span("export.write"):
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, stem + ".txt"), "wb") as f:
            f.write(body)


def export_scene(results_root: str, scene_name: str, stage: str,
                 out: Stage1Output, extras: dict | None = None) -> None:
    """Write final and per-layer label files of one scene under
    results_root/<scene_name>/<stage>/ (reference model.py:688-691). A
    prepared scene's `extras["unmap"]` (mesh vertex -> resampled point)
    carries the labels back to the mesh vertices."""
    out_dir = os.path.join(results_root, scene_name, stage)
    unmap = (extras or {}).get("unmap")

    def host(t):
        arr = profiling.to_host(t).numpy()
        return arr if unmap is None else arr[unmap]

    export_labels_txt(out_dir, "final.sem", host(out.final_sem))
    export_labels_txt(out_dir, "final.ins", host(out.final_ins))
    export_labels_txt(out_dir, "final.seg", host(out.final_root))
    for li in range(out.layer_roots.shape[0]):
        export_labels_txt(out_dir, f"layer_{li+1}.seg", host(out.layer_roots[li]))
        export_labels_txt(out_dir, f"layer_{li+1}.sem", host(out.layer_sem[li]))
        export_labels_txt(out_dir, f"layer_{li+1}.ins", host(out.layer_ins[li]))


def infer_scenes(
    model: SegGroupGNN,
    scenes: Sequence[Scene],
    mode: str = "ins_infer",
    results_root: str | None = None,
    names: Sequence[str] | None = None,
    phase_seconds: dict | None = None,
) -> list[Stage1Output]:
    """Run the forward on each scene (moved to the model's device). With
    `results_root`, write each scene's labels under
    results_root/<name>/<mode>/, names defaulting to scene_0000, ...
    `phase_seconds` is passed to the forward (see SegGroupGNN.forward), and
    the export's wall seconds, unfenced, are added to it under "export";
    inside the export the recorder adds "export.format" and "export.write"
    (export_labels_txt, 15 of each a scene) and its reads of the card to
    "host.read" (utils/profiling.py), each with its "count." key."""
    outs = []
    clock = PhaseClock(None, phase_seconds)
    for i, scene in enumerate(scenes):
        out = model(scene.to(model.device), mode=mode, phase_seconds=phase_seconds)
        if results_root is not None:
            name = names[i] if names is not None else f"scene_{i:04d}"
            with clock("export"):
                export_scene(results_root, name, mode, out)
        outs.append(out)
    return outs
