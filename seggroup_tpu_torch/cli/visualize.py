"""Label visualization CLI (cli/visualize.py of the JAX package; reference
seggroup/visualize.py): recolor a mesh by an exported label file and write
a PLY. With --process_dir, visualize the whole grouping process: one PLY
per exported layer_*.seg.txt (reference visualize_grouping_process,
dataset/scannet/util.py:489-527). Host only, numpy.

    python -m seggroup_tpu_torch.cli.visualize --mesh scene0000_00_vh_clean_2.ply \
        --labels results/exp/scene0000_00/ins_infer/final.sem.txt \
        --label_type semantic --out vis/scene0000_00.sem.ply
    python -m seggroup_tpu_torch.cli.visualize --mesh scene0000_00_vh_clean_2.ply \
        --process_dir results/exp/scene0000_00/ins_infer --out vis/proc
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from seggroup_tpu_torch.data.visualize import visualize_labels


def main(argv=None):
    p = argparse.ArgumentParser("label visualization")
    p.add_argument("--mesh", type=str, required=True)
    p.add_argument("--labels", type=str, default=None,
                   help="txt file, one int per vertex")
    p.add_argument("--process_dir", type=str, default=None,
                   help="results/<scene>/<stage> dir: visualize every "
                        "layer_*.seg.txt (grouping process)")
    p.add_argument("--label_type", type=str, default="semantic",
                   choices=["semantic", "instance", "segment"])
    p.add_argument("--shuffle", action="store_true")
    p.add_argument("--out", type=str, required=True)
    args = p.parse_args(argv)

    if args.process_dir:
        import glob

        from seggroup_tpu_torch.data.visualize import visualize_grouping_process

        os.makedirs(args.out, exist_ok=True)
        files = sorted(glob.glob(os.path.join(args.process_dir,
                                              "layer_*.seg.txt")))
        if not files:
            raise SystemExit(f"no layer_*.seg.txt under {args.process_dir}")
        for fp in files:
            name = os.path.basename(fp).replace(".seg.txt", "")
            seg = np.loadtxt(fp, dtype=np.int64)
            out = os.path.join(args.out, f"{name}.ply")
            # merge-progress view (reference visualize_grouping_process):
            # instance colors where this layer's ins labels exist, segment
            # colors elsewhere; final.ins as the last-layer fallback
            ins_fp = fp.replace(".seg.txt", ".ins.txt")
            if not os.path.exists(ins_fp):
                ins_fp = os.path.join(args.process_dir, "final.ins.txt")
            if os.path.exists(ins_fp):
                ins = np.loadtxt(ins_fp, dtype=np.int64)
                visualize_grouping_process(args.mesh, ins, seg, out,
                                           shuffle=args.shuffle)
            else:
                visualize_labels(args.mesh, seg, out, "segment",
                                 args.shuffle)
            print(f"wrote {out}")
        return
    if not args.labels:
        raise SystemExit("need --labels or --process_dir")
    labels = np.loadtxt(args.labels, dtype=np.int64)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    visualize_labels(args.mesh, labels, args.out, args.label_type,
                     args.shuffle)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
