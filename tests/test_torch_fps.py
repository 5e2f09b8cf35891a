"""Port FPS (seggroup_tpu_torch.ops.fps) against JAX `masked_fps` and the
Pallas kernel `masked_fps_pallas` (interpret mode), index for index.

The plain PyTorch version forms squared distances in XLA's CPU contraction
order (ops/fma.py); with plain float32 sums about a fifth of the distances
round differently and picks diverge. The CUDA kernel is held against the
plain version on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from seggroup_tpu.ops import fps as jax_fps
from seggroup_tpu.ops.pallas_fps import masked_fps_pallas
from seggroup_tpu_torch.models.seggroup import SegGroupGNN
from seggroup_tpu_torch.ops import cuda_fps
from seggroup_tpu_torch.ops.fps import farthest_point_sampling, masked_fps

torch.set_num_threads(1)

# under jit, as the JAX model calls it (XLA's fusion decides the rounding)
jax_masked_fps = jax.jit(jax_fps.masked_fps, static_argnums=2)


def _cases():
    rng = np.random.default_rng(0)
    b, p, k = 6, 128, 16
    pts = rng.normal(size=(b, p, 3)).astype(np.float32)
    valid = np.ones((b, p), bool)
    valid[0, 100:] = False
    valid[1, 8:] = False            # fewer valid points than k
    valid[2, 1:] = False            # one valid point
    valid[3] = False                # none valid
    pts[4, 64:] = pts[4, :64]       # every point duplicated
    pts[5, 120] = [100, 100, 100]   # far outlier, invalid
    valid[5, 110:] = False
    yield "edge_rows", pts, valid, k
    # the stage-1 call's shape for one batch of rows: P=cluster_cap=1024, k=64
    b, p, k = 64, 1024, 64
    pts = (rng.normal(size=(b, p, 3)) * 2).astype(np.float32)
    lengths = rng.integers(1, p + 1, size=b)
    lengths[:4] = [1, 20, 63, 64]
    valid = np.arange(p)[None, :] < lengths[:, None]
    yield "stage1_shape", pts, valid, k


CASES = {name: (pts, valid, k) for name, pts, valid, k in _cases()}


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    for name, (pts, valid, k) in CASES.items():
        xla = np.asarray(jax_masked_fps(jnp.asarray(pts), jnp.asarray(valid), k))
        with pltpu.force_tpu_interpret_mode():
            pallas = np.asarray(masked_fps_pallas(jnp.asarray(pts), jnp.asarray(valid), k))
        out[name] = (xla, pallas)
    return out


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_fps_matches_jax(name, reference, jax_results):
    pts, valid, k = CASES[name]
    got = masked_fps(torch.from_numpy(pts), torch.from_numpy(valid), k)
    assert got.dtype == torch.int32 and tuple(got.shape) == (pts.shape[0], k)
    want = jax_results[name][0 if reference == "xla" else 1]
    np.testing.assert_array_equal(got.numpy(), want)


def test_never_selects_invalid_while_valid_remain():
    pts, valid, k = CASES["edge_rows"]
    got = masked_fps(torch.from_numpy(pts), torch.from_numpy(valid), k).numpy()
    assert (got[0] < 100).all()
    assert (got[5] < 110).all()
    assert (got[2] == 0).all()      # the one valid point, repeated


def test_farthest_point_sampling_unmasked():
    pts = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
    want = np.asarray(jax_masked_fps(jnp.asarray(pts[None]), jnp.ones((1, 50), bool), 8))[0]
    got = farthest_point_sampling(torch.from_numpy(pts), 8).numpy()
    np.testing.assert_array_equal(got, want)


def test_cpu_tensors_take_the_plain_version():
    """The CUDA wrapper imports without nvcc; a CPU tensor never reaches it,
    and the wrapper refuses CPU tensors."""
    pts, valid, k = CASES["edge_rows"]
    before = cuda_fps.launches
    masked_fps(torch.from_numpy(pts), torch.from_numpy(valid), k)
    assert cuda_fps.launches == before
    with pytest.raises(ValueError):
        cuda_fps.masked_fps_cuda(torch.from_numpy(pts), torch.from_numpy(valid), k)


@pytest.mark.parametrize("p,design", [(1, "warps"), (31, "warps"), (33, "warps"),
                                      (1024, "warps"), (4096, "warps"), (4097, "block"),
                                      (16384, "block")])
def test_design_chosen_by_row_length(p, design):
    """K1 serves rows of up to 4,096 candidates with its warps design (the
    stage-1 call, at the model's cluster cap of 1,024, among them) and
    longer rows with its block design."""
    assert cuda_fps.variant(p) == design
    cap = inspect.signature(SegGroupGNN).parameters["cluster_cap"].default
    assert cap == 1024 and cuda_fps.variant(cap) == "warps"
