"""Weights of the JAX SegGroupGNN -> state_dict of the port's SegGroupGNN.

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
