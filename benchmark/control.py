"""Readings from which a cell's limits are set: for each seed, the numbers
the check compares for the program (its window's output against the plain
reference) and for the control (the reference at one precision step below
the configuration's, in the program's place), in one process.

    python -m benchmark.control --workload <name> --seconds <s> --seeds <n> [<n> ...]
        [--fault half_batch] [--units <n>]

`--fault` plants a fault in the program first: `half_batch`, the mean over
the first half of the batch (the MinkUNet trainer's voxels, or the
data-parallel ranks); `unchanged_state`, the MinkUNet trainer's optimizer
step left out; `altered_label`, every hundredth exported label
changed; `no_exchange`, the data-parallel ranks' gradients left out of
their all-reduce. `--units n` reads the control alone, over the first n
units a window would run, without running the window (a driver with
`assume_exported`). The benchmark's own runs never run this module. Prints
one JSON line a seed."""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time

from benchmark.run import ROOT, _cache_dirs


def plant(fault: str, set_attr=setattr) -> None:
    """Plant `fault` in the program of this process through `set_attr`
    (a test passes its monkeypatch's)."""
    import torch

    if fault == "half_batch":
        from seggroup_tpu_torch.cli import stage2_train_minkunet as trainer

        whole = trainer.masked_nll

        def half(logits, labels, valid):
            rows = torch.arange(valid.shape[0], device=valid.device) < int(valid.sum()) // 2
            return whole(logits, labels, valid & rows)

        set_attr(trainer, "masked_nll", half)
    elif fault == "unchanged_state":
        set_attr(torch.optim.SGD, "step", lambda self, closure=None: None)
    elif fault == "altered_label":
        from seggroup_tpu_torch import infer

        write = infer.export_labels_txt

        def altered(out_dir, stem, labels):
            labels = labels.copy()
            labels[::100] += 1
            write(out_dir, stem, labels)

        set_attr(infer, "export_labels_txt", altered)
    else:
        raise SystemExit(f"unknown fault {fault!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="program and control readings of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--control_seeds", type=int, default=None,
                    help="read the control on the first n seeds only (default: all)")
    ap.add_argument("--units", type=int, default=None,
                    help="the control alone over the first n units of a window")
    args = ap.parse_args(argv)
    _cache_dirs()
    from benchmark import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    spec = harness.cell_spec(bench, args.workload, 0, args.seconds, False, args.device)
    drv = harness.driver(spec.traffic["driver"])
    in_ranks = hasattr(drv, "plant")  # a driver whose ranks plant their own faults
    if args.fault and not in_ranks:
        plant(args.fault)
    for j, seed in enumerate(args.seeds):
        spec = harness.cell_spec(bench, args.workload, seed, args.seconds, False, args.device)
        if args.fault and in_ranks:
            spec.traffic["fault"] = args.fault
        t0 = time.perf_counter()
        st = drv.setup(spec)
        if args.units:
            drv.assume_exported(st, args.units)
            drv.release(st)
            line = {"workload": args.workload, "seed": seed, "units": args.units,
                    "control": drv.readings(st, lower=True)}
        else:
            out = drv.window(st, args.seconds, False)
            drv.release(st)
            line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                    "attempted": out.attempted, "end_to_end": out.end_to_end,
                    "program": drv.readings(st)}
        if not args.units and (args.control_seeds is None or j < args.control_seeds):
            line["control"] = drv.readings(st, lower=True)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        if hasattr(st, "work"):
            shutil.rmtree(st.work, ignore_errors=True)
        del st
    return 0


if __name__ == "__main__":
    sys.exit(main())
