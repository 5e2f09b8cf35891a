"""Console and file tee logger (seggroup_tpu/utils/logging.py, reference
IOStream, seggroup/util.py:41-51)."""

from __future__ import annotations

import os


class IOStream:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.f = open(path, "a")

    def cprint(self, text: str):
        print(text, flush=True)
        self.f.write(text + "\n")
        self.f.flush()

    def close(self):
        self.f.close()
