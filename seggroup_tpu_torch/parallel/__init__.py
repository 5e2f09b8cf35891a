"""Data parallelism and point sharding over torch.distributed
(seggroup_tpu/parallel): `dp` starts one process a rank and holds the
data-parallel train and inference steps, `point_sharding` the stage-1
model with its point axis split over the ranks."""

from seggroup_tpu_torch.parallel.dp import (Mesh, build_stage1_infer_step,
                                            build_stage1_train_step, launch, make_mesh)

__all__ = ["Mesh", "make_mesh", "launch", "build_stage1_train_step", "build_stage1_infer_step"]
