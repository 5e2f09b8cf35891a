"""Console and file tee logger (seggroup_tpu/utils/logging.py, reference
IOStream, seggroup/util.py:41-51). Disabled (`enabled=False`, the ranks
other than 0 of a data-parallel run), it writes nothing."""

from __future__ import annotations

import os


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
