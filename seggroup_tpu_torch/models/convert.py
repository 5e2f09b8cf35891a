"""Weights of the JAX models -> state_dicts of the port's: SegGroupGNN
(`params_from_flax`), MinkUNet (`minkunet_params_from_flax`), PointGroup
(`pointgroup_params_from_flax`), KPFCNN (`kpconv_params_from_flax`) and
KPCNN (`kpcnn_params_from_flax`). `minkunet_params_from_flax` also maps
every other voxel family of the registry, whose port keeps the flax names:
ResUNet and MinkUNetHyper (`final_fc`, the instance norms' `{name}_in`),
SparseResNet, the registry's `kpcnn`, and CRFWrapped (`backbone/...`, the
CRF's (K, C, C) `crf/kernel` as it is).

The JAX variables are `{"params": ..., "batch_stats": ...}` trees of numpy
arrays (`jax.tree.map(np.asarray, variables)`). Flax `Dense` kernels are
(in, out); torch `Linear` weights are (out, in). MaskedBatchNorm keeps the
flax names: `scale`, `bias` (params) and `mean`, `var` (batch_stats)."""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

# module -> (dense layers, batch norms), in the flax tree's names
_LAYOUT = {
    "mlp_1": (("conv1",), ("bn1",)),
    "mlp_2": (("conv1",), ("bn1",)),
    "gcn_2": (("fc",), ()),
    "mlp_3": (("conv1", "conv2"), ("bn1", "bn2")),
    "gcn_3": (("fc",), ()),
    "classifier": (("linear1", "linear2"), ("bn1",)),
}


def params_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """state_dict entries for every module present in `variables`. A tree
    initialised in an inference mode has no `classifier`; its entries are
    then absent and the caller loads with `strict=False`."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})

    def t(x):
        return torch.from_numpy(np.array(x, dtype=np.float32))

    out = {}
    for mod, (denses, norms) in _LAYOUT.items():
        if mod not in params:
            continue
        for name in denses:
            layer = params[mod][name]
            out[f"{mod}.{name}.weight"] = t(layer["kernel"]).T.contiguous()
            if "bias" in layer:
                out[f"{mod}.{name}.bias"] = t(layer["bias"])
        for name in norms:
            out[f"{mod}.{name}.scale"] = t(params[mod][name]["scale"])
            out[f"{mod}.{name}.bias"] = t(params[mod][name]["bias"])
            out[f"{mod}.{name}.mean"] = t(stats[mod][name]["mean"])
            out[f"{mod}.{name}.var"] = t(stats[mod][name]["var"])
    return out


def _flatten(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def minkunet_params_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """state_dict of models.minkunet.MinkUNet from the flax MinkUNet's
    `{"params", "batch_stats"}` trees. The port keeps the flax names, so a
    path maps to its dotted key: submanifold and strided kernels
    (`conv0/kernel`, `conv1s2_kernel`, `block1_0/conv1/kernel`, ...) keep
    their (K, Cin, Cout) layout; Dense kernels (2-D: `downsample`,
    Bottleneck `conv1`/`conv3`, `final`) become `.weight`, transposed;
    biases, BatchNorm `scale`/`bias` and `mean`/`var` go across as they are."""
    out = {}
    for path, x in _flatten(variables["params"]):
        x = torch.from_numpy(np.array(x, dtype=np.float32))
        if path[-1] == "kernel" and x.ndim == 2:
            out[".".join(path[:-1] + ("weight",))] = x.T.contiguous()
        else:
            out[".".join(path)] = x
    for path, x in _flatten(variables.get("batch_stats", {})):
        out[".".join(path)] = torch.from_numpy(np.array(x, dtype=np.float32))
    return out


def pointgroup_params_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """state_dict of models.pointgroup.PointGroup from the flax PointGroup's
    `{"params", "batch_stats"}` trees. The port keeps the flax names, the
    recursive `unet/u/u/...` and `score_unet/u` among them, so the rule is
    MinkUNet's: conv kernels ((K, Cin, Cout) `kernel`, `conv_kernel`,
    `deconv_kernel`) as they are, the four Dense heads' 2-D kernels
    transposed into `.weight`, BatchNorm parameters and statistics as they
    are. A tree initialised without clustering has no ScoreNet entries; the
    caller then loads with `strict=False`."""
    return minkunet_params_from_flax(variables)


def kpconv_params_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """state_dict of models.kpconv.KPFCNN from the flax KPFCNN's
    `{"params", "batch_stats"}` trees. The port keeps the flax names
    (`b0_kp/kernel`, `b5/kp/offset_kernel`, `b5/kp/offset_mlp/kernel`,
    `b11_unary/kernel`, `head_bn/scale`, ...), so the rule is MinkUNet's:
    the (P, Cin, Cout) `kernel` and `offset_kernel` as they are, Dense
    kernels (2-D, the deformable v2 `offset_mlp` among them) transposed into
    `.weight`, biases, TFBatchNorm `scale`/`bias` and `mean`/`var` as they
    are."""
    return minkunet_params_from_flax(variables)


def kpcnn_params_from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """state_dict of models.kpconv.KPCNN from the flax KPCNN's trees: the
    encoder as `kpconv_params_from_flax` maps it, and the head's `fc`,
    `fc_bn` and `softmax` by the same rule."""
    return minkunet_params_from_flax(variables)
