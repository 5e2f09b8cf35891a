"""The port's sparse ResNet classifiers and the KPConv-block KPCNN head
(seggroup_tpu_torch.models.resnet_sparse), and `global_pool`, against
seggroup_tpu/models/resnet_sparse.py and sparse/conv.py on the CPU at
shared weights (models.convert.minkunet_params_from_flax).

`global_pool`: the max exactly JAX's, the mean within rtol = atol = 1e-6.
SparseResNet (ResNet14 on 4-column coords, STResTesseractNet14 on 5-column
coords with its 81-offset blocks) at narrow widths (planes 8-32, stem 8)
with the BatchNorm statistics randomised: per-scene logits within the
MinkUNet tolerance of tests/test_torch_minkunet.py (bf16 convs on both
sides). KPCNN (the `kpcnn` of the registry) on tests/test_torch_kpcnn.py's
batch of 3 shapes: logits within 1e-5 of their magnitude, as that file
holds models.kpconv.KPCNN."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.models import kpconv as JK
from seggroup_tpu.models import resnet_sparse as J
from seggroup_tpu.sparse.conv import global_pool as j_pool
from seggroup_tpu.sparse.tensor import SparseTensor as JST
from seggroup_tpu_torch.models import kpconv as TK
from seggroup_tpu_torch.models import resnet_sparse as T
from seggroup_tpu_torch.models.convert import minkunet_params_from_flax
from seggroup_tpu_torch.sparse.conv import global_pool as t_pool
from seggroup_tpu_torch.sparse.tensor import SparseTensor as TST

from test_torch_kpcnn import B, C, DL0, FDIM, N, _batch, _randomize
from test_torch_minkunet import ATOL, RTOL, _randomize_stats, make_sparse_input
from test_torch_spatiotemporal import make_st_input

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["mean", "max"])
def test_global_pool_matches_jax(mode):
    rng = np.random.default_rng(1)
    m = 300
    coords = np.zeros((m, 4), np.int32)
    coords[:, 0] = rng.integers(0, 3, m)  # batch element 3 of 4 stays empty
    feats = rng.normal(size=(m, 7)).astype(np.float32)
    valid = rng.random(m) < 0.7
    js = JST(jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(valid), jnp.int32(0))
    ts = TST(torch.from_numpy(coords), torch.from_numpy(feats), torch.from_numpy(valid),
             torch.tensor(0, dtype=torch.int32))
    want = np.asarray(jax.jit(lambda s: j_pool(s, 4, mode))(js))
    got = t_pool(ts, 4, mode).numpy()
    assert got.shape == (4, 7) and (want[3] == 0).all()
    if mode == "max":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("variant", ["ResNet14", "STResTesseractNet14"])
def test_sparse_resnet_matches_jax(variant):
    rng = np.random.default_rng(2)
    st5 = variant.startswith("ST")
    js, ts = (make_st_input(rng, m_cap=256, n=200, grid=10) if st5
              else make_sparse_input(rng, m_cap=256, n=200, grid=12))
    cfg = (J.ST_RESNET_VARIANTS if st5 else J.RESNET_VARIANTS)[variant]
    kw = dict(out_channels=C, planes=(8, 16, 16, 32), init_dim=8, num_batches=2,
              layers=cfg["layers"],
              block_conv_type=cfg.get("block_conv_type", "spatial_hypercube_temporal_hypercross"))
    jmodel = J.SparseResNet(**kw)
    port = T.SparseResNet(ndim=4 if st5 else 3, device="cpu", **kw)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda r, s: jmodel.init(r, s, train=False))(jax.random.PRNGKey(3), js))
    variables["batch_stats"] = _randomize_stats(variables["batch_stats"], rng)
    port.load_state_dict(minkunet_params_from_flax(variables), strict=True)
    assert port.stage0_block0.conv1.kernel.shape[0] == (81 if st5 else 27)
    want = np.asarray(jax.jit(lambda v, s: jmodel.apply(v, s, train=False))(variables, js))
    with torch.no_grad():
        got = port(ts, train=False).numpy()
    assert got.shape == (2, C)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert T.RESNET_VARIANTS.keys() == J.RESNET_VARIANTS.keys()
    assert T.ST_RESNET_VARIANTS.keys() == J.ST_RESNET_VARIANTS.keys()


def test_kpcnn_matches_jax():
    with pytest.MonkeyPatch.context() as mp:
        # the JAX function's kernel points, bit-equal to the port's
        # (tests/test_torch_kpconv.py), so the numpy optimisation runs once
        mp.setattr(TK, "kernel_point_positions", JK.kernel_point_positions)
        jl, tl = _batch(absent=True)
        model = J.KPCNN(num_classes=C, first_features_dim=FDIM, dl0=DL0, num_batches=B)
        feats = jnp.ones((N, 1), jnp.float32)
        v = jax.jit(lambda r, py, f, b: model.init(r, py, f, b, train=False))(
            jax.random.PRNGKey(0), jl, feats, jl[3].batch)
        v = _randomize(v, 4)
        port = T.KPCNN(num_classes=C, first_features_dim=FDIM, dl0=DL0, num_batches=B,
                       device="cpu")
        port.load_state_dict(minkunet_params_from_flax(v), strict=True)
        want, want_reg = jax.jit(lambda v, py, f, b: model.apply(v, py, f, b, train=False))(
            v, jl, feats, jl[3].batch)
        with torch.no_grad():
            got, reg = port(tl, torch.ones((N, 1)), tl[3].batch)
    want = np.asarray(want)
    assert got.shape == (B, C)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert float(reg) == float(want_reg) == 0.0
    n_jax = sum(x.size for x in jax.tree.leaves(v["params"]))
    assert sum(p.numel() for p in port.parameters()) == n_jax
