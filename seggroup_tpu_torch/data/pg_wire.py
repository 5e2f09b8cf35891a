"""Compact wire format of a PointGroup training batch
(seggroup_tpu/data/pg_wire.py): the host voxelises, and the batch travels
as int16 voxel coords, an int32 point -> voxel map, float32 coords and
float16 colours; the card rebuilds the voxel features from them.

The colours are rounded to float16 on the way, so the model sees the
float16 values, as the JAX trainer's default `--plan_mode device` does;
the trainer then builds the U-Net's pyramid plan on the card
(sparse/device_plan.py). `host_batch_on_device` is the `--plan_mode host`
counterpart: the float32 host batch and its host voxelisation, the voxel
features made on the card the same way."""

from __future__ import annotations

import numpy as np
import torch

from seggroup_tpu_torch.ops.segment_ops import segment_mean_sorted
from seggroup_tpu_torch.ops.voxelize import VoxelMap
from seggroup_tpu_torch.sparse.tensor import SparseTensor


def pack_pg_batch(hb, vcoords: np.ndarray, num, p2v: np.ndarray) -> dict[str, np.ndarray]:
    """hb: a batch with coords/feats/batch_ids/valid/labels/instance_labels/
    instance_centroid/instance_pointnum arrays
    (cli.stage2_pointgroup_common.PGHostBatch); vcoords, num, p2v: its
    voxelisation (host_voxelize_plan)."""
    if len(vcoords) and (vcoords.max() >= 32000 or vcoords.min() < 0):
        raise ValueError("voxel coords exceed int16 wire range")
    return {
        "vcoords": vcoords.astype(np.int16),
        "num": np.int32(num),
        "p2v": p2v.astype(np.int32),
        "coords": hb.coords.astype(np.float32),
        "feats": hb.feats.astype(np.float16),
        "batch_ids": hb.batch_ids.astype(np.uint8),
        "nvalid": np.int32(hb.valid.sum()),
        "labels": hb.labels.astype(np.int8),  # IGNORE = -100, classes 0..19
        "inst": hb.instance_labels.astype(np.int16),
        "centroid": hb.instance_centroid.astype(np.float32),
        "pointnum": hb.instance_pointnum.astype(np.int32),
    }


def unpack_pg_batch(w: dict[str, np.ndarray], voxel_cap: int, device: str | torch.device):
    """The inverse of pack_pg_batch on `device`: (st, p2v, coords,
    batch_ids, valid, labels, inst, centroid, pointnum), the voxel features
    the mean of each voxel's points' [colours, coords] in the JAX side's
    summation order (its sorted `voxel_gather_mean`)."""
    return _on_device(w["vcoords"], w["num"], w["p2v"], w["coords"], w["feats"],
                      w["batch_ids"], w["nvalid"], w["labels"], w["inst"], w["centroid"],
                      w["pointnum"], voxel_cap, device)


def host_batch_on_device(hb, vcoords: np.ndarray, num, p2v: np.ndarray, voxel_cap: int,
                         device: str | torch.device):
    """unpack_pg_batch's tuple from the float32 host batch `hb` (a
    PGHostBatch) and its voxelisation, without the wire's rounding (the
    JAX trainer's `--plan_mode host` `to_device`)."""
    return _on_device(vcoords, num, p2v, hb.coords, hb.feats, hb.batch_ids, hb.valid.sum(),
                      hb.labels, hb.instance_labels, hb.instance_centroid,
                      hb.instance_pointnum, voxel_cap, device)


def _on_device(vcoords, num, p2v, coords, colours, batch_ids, nvalid, labels, inst, centroid,
               pointnum, voxel_cap, device):
    def dev(x):
        return torch.from_numpy(np.asarray(x)).to(device)

    num = int(num)
    vm = VoxelMap(dev(vcoords).to(torch.int32), dev(p2v).to(torch.int32),
                  torch.arange(voxel_cap, device=device) < num,
                  torch.tensor(num, dtype=torch.int32, device=device))
    coords = dev(coords).to(torch.float32)
    feats = torch.cat([dev(colours).to(torch.float32), coords], dim=1)
    st = SparseTensor(vm.voxel_coords, segment_mean_sorted(feats, vm.point2voxel, voxel_cap),
                      vm.voxel_valid, vm.num_voxels)
    valid = torch.arange(coords.shape[0], device=device) < int(nvalid)
    return (st, vm.point2voxel, coords, dev(batch_ids).to(torch.int32), valid,
            dev(labels).to(torch.int32), dev(inst).to(torch.int32),
            dev(centroid).to(torch.float32), dev(pointnum).to(torch.int32))
