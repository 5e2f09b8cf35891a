"""The model registry (seggroup_tpu/models/__init__.py): `get_model(name,
**kwargs)` builds the named model, with exactly the JAX registry's names:
`seggroup_gnn`, `pointgroup`, `kpfcnn`, `kpcnn` (models.resnet_sparse),
`kpcnn_kp` (models.kpconv), every Res16UNet, ST, ResUNet, MinkUNetHyper and
sparse ResNet variant, and `BilateralCRF-<Res16UNet variant>` /
`TrilateralCRF-<Res16UNet variant>`. The constructors also take `seed` and
`device`, as the port's models do.

The table is filled at the first `get_model` or `model_names` call, and a
constructor imports its module when it is called: importing the registry
imports no model module."""

from __future__ import annotations

import functools
import importlib

__all__ = ["register", "get_model", "model_names"]

_REGISTRY: dict = {}


def register(name):
    """Decorator: registers a constructor under `name`."""
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def _lazy(module: str, attr: str, *args):
    """A constructor that imports `module` when called and calls its `attr`
    with `args` before the caller's keywords."""
    def make(**kwargs):
        return getattr(importlib.import_module(f"seggroup_tpu_torch.models.{module}"),
                       attr)(*args, **kwargs)

    return make


def _make_crf(variant: str, temporal: bool):
    """CRF-wrapped Res16UNet (reference wrapper_type BilateralCRF /
    TrilateralCRF), both drawn from `seed`."""
    def make(out_channels: int = 20, seed: int = 0, **kwargs):
        from seggroup_tpu_torch.models.crf import CRFWrapped
        from seggroup_tpu_torch.models.minkunet import make_minkunet

        backbone = make_minkunet(variant, out_channels=out_channels, seed=seed, **kwargs)
        return CRFWrapped(backbone, num_classes=out_channels, temporal=temporal, seed=seed)

    return make


@functools.cache
def _fill() -> None:
    from seggroup_tpu_torch.models import minkunet as mk
    from seggroup_tpu_torch.models import resnet_sparse as rs

    table = {"seggroup_gnn": _lazy("seggroup", "SegGroupGNN"),
             "pointgroup": _lazy("pointgroup", "PointGroup"),
             "kpfcnn": _lazy("kpconv", "KPFCNN"),
             "kpcnn": _lazy("resnet_sparse", "KPCNN"),  # KPConv blocks, mean pool, head
             "kpcnn_kp": _lazy("kpconv", "KPCNN")}  # the reference's KPCNN
    for names, make in ((list(mk.VARIANTS) + list(mk.ST_VARIANTS), "make_minkunet"),
                        (list(mk.RESUNET_VARIANTS) + list(mk.ST_RESUNET_VARIANTS),
                         "make_resunet"),
                        (list(mk.HYPER_VARIANTS), "make_hyper"),
                        (list(rs.RESNET_VARIANTS) + list(rs.ST_RESNET_VARIANTS),
                         "make_sparse_resnet")):
        module = "resnet_sparse" if make == "make_sparse_resnet" else "minkunet"
        table.update({name: _lazy(module, make, name) for name in names})
    for name in mk.VARIANTS:
        table[f"BilateralCRF-{name}"] = _make_crf(name, False)
        table[f"TrilateralCRF-{name}"] = _make_crf(name, True)
    for name, make in table.items():
        _REGISTRY.setdefault(name, make)


def model_names() -> list[str]:
    _fill()
    return sorted(_REGISTRY)


def get_model(name: str, **kwargs):
    _fill()
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
