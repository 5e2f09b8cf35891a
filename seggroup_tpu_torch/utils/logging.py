"""Console and file tee logger and the per-class IoU table
(seggroup_tpu/utils/logging.py, reference IOStream, seggroup/util.py:41-51,
and print_class_iou, train.py:62-75). Disabled (`enabled=False`, the ranks
other than 0 of a data-parallel run), the logger writes nothing."""

from __future__ import annotations

import os

import numpy as np

CLASS_NAMES_20 = [
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture",
]


class IOStream:
    def __init__(self, path: str, enabled: bool = True):
        self.f = None
        if enabled:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self.f = open(path, "a")

    def cprint(self, text: str):
        if self.f is None:
            return
        print(text, flush=True)
        self.f.write(text + "\n")
        self.f.flush()

    def close(self):
        if self.f is not None:
            self.f.close()


def format_class_iou_table(iou_sem_sel: np.ndarray, iou_ins_sel: np.ndarray,
                           acc_sem_sel: float, acc_ins_sel: float) -> str:
    """The per-class semantic and instance IoU table (in %) with the means
    and the selected points' accuracies. The instance column has no entry
    for the first two classes (wall, floor): they show nan."""
    lines = ["%-16s %10s %10s" % ("class", "sem IoU", "ins IoU")]
    for name, s, i in zip(CLASS_NAMES_20, iou_sem_sel, [np.nan, np.nan] + list(iou_ins_sel)):
        lines.append("%-16s %10.2f %10.2f" % (name, 100 * s, 100 * i))
    lines.append("mean sem IoU %.2f%%  mean ins IoU %.2f%%  sel acc sem %.2f%% ins %.2f%%"
                 % (100 * np.nanmean(iou_sem_sel), 100 * np.nanmean(iou_ins_sel),
                    100 * acc_sem_sel, 100 * acc_ins_sel))
    return "\n".join(lines)
