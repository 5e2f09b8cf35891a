"""Training-curve extraction/plots from run logs (cli/plot_convergence.py
of the JAX package; reference kpconv/plot_convergence.py): parses the
drivers' log files into CSV, prints an ASCII sparkline summary, and with
--png renders matplotlib curves (multiple logs overlay like the reference's
multi-run comparisons) where matplotlib imports; without it the PNG is
skipped with a message and the rest still runs.

    python -m seggroup_tpu_torch.cli.plot_convergence --log checkpoints/exp/minkunet.log \
        --out curve.csv
    python -m seggroup_tpu_torch.cli.plot_convergence --log run_a/minkunet.log \
        run_b/minkunet.log --png curves.png
"""

from __future__ import annotations

import argparse
import csv
import re
import sys

PATTERNS = [
    ("loss", re.compile(r"[Ll]oss:?\s+([0-9.]+)")),
    ("sem_miou", re.compile(r"Sem mIoU:\s+([0-9.]+)%")),
    ("ins_miou", re.compile(r"Ins mIoU:\s+([0-9.]+)%")),
    ("acc", re.compile(r"acc\s+([0-9.]+)%")),
    ("running_miou", re.compile(r"running mIoU\s+([0-9.]+)%")),
]

SPARK = "▁▂▃▄▅▆▇█"


def sparkline(vals):
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    rng = (hi - lo) or 1.0
    return "".join(SPARK[int((v - lo) / rng * (len(SPARK) - 1))] for v in vals)


def main(argv=None):
    p = argparse.ArgumentParser("training-curve extraction")
    p.add_argument("--log", type=str, nargs="+", required=True,
                   help="one or more run logs (multiple overlay in --png)")
    p.add_argument("--out", type=str, default=None, help="CSV output path")
    p.add_argument("--png", type=str, default=None,
                   help="matplotlib PNG output (reference-style curves)")
    args = p.parse_args(argv)

    def parse(path):
        rows = []
        with open(path) as f:
            for i, line in enumerate(f):
                row = {"step": i}
                hit = False
                for name, pat in PATTERNS:
                    m = pat.search(line)
                    if m:
                        row[name] = float(m.group(1))
                        hit = True
                if hit:
                    rows.append(row)
        return rows

    per_log = {path: parse(path) for path in args.log}
    rows = per_log[args.log[0]]
    if not rows:
        print("no metric lines found", file=sys.stderr)
        return

    keys = sorted({k for r in rows for k in r} - {"step"})

    plt = None
    if args.png:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print(f"matplotlib is not installed: {args.png} not written", file=sys.stderr)
    if plt is not None:
        all_keys = sorted({k for rws in per_log.values()
                           for r in rws for k in r} - {"step"})
        fig, axes = plt.subplots(1, len(all_keys),
                                 figsize=(4.5 * len(all_keys), 3.2))
        if len(all_keys) == 1:
            axes = [axes]
        for ax, k in zip(axes, all_keys):
            for path, rws in per_log.items():
                xy = [(r["step"], r[k]) for r in rws if k in r]
                if xy:
                    ax.plot(*zip(*xy), label=path.split("/")[-2]
                            if "/" in path else path, linewidth=1)
            ax.set_title(k)
            ax.set_xlabel("log line")
            ax.grid(alpha=0.3)
        axes[0].legend(fontsize=7)
        fig.tight_layout()
        fig.savefig(args.png, dpi=120)
        print(f"wrote {args.png}")
    for k in keys:
        vals = [r[k] for r in rows if k in r]
        # subsample to 60 chars
        step = max(1, len(vals) // 60)
        sub = vals[::step]
        print(f"{k:>14}: {sparkline(sub)}  first {vals[0]:.3f}  last {vals[-1]:.3f}")
    if args.out:
        with open(args.out, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["step"] + keys)
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.out} ({len(rows)} rows)")


if __name__ == "__main__":
    main()
