"""Host utilities of the port: checkpoints, logging, the host prefetcher,
the scalar writer and profiling (seggroup_tpu/utils/).

seggroup_tpu/utils/jit_cache.py has no counterpart: it keeps XLA's
persistent compilation cache, and the port compiles nothing at run time
but its hand-written kernels and host library, each built once per source
into `seggroup_tpu_torch/_build/` (cuda_build.py) and reused after."""

from seggroup_tpu_torch.utils.logging import CLASS_NAMES_20, IOStream, format_class_iou_table

__all__ = ["CLASS_NAMES_20", "IOStream", "format_class_iou_table"]
