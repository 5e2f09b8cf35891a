"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`: without a card each test skips. The file imports no
JAX, so on a machine without it these run with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`."""

import numpy as np
import pytest
import torch

from seggroup_tpu_torch.ops import cuda_fps
from seggroup_tpu_torch.ops.fps import masked_fps, masked_fps_plain

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _fps_case(b, p, lengths, seed=0, grid=None):
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(b, p, 3)) * 2).astype(np.float32)
    if grid:
        pts = np.round(pts * grid) / grid  # many equal points
    valid = np.arange(p)[None, :] < np.asarray(lengths)[:, None]
    return torch.from_numpy(pts), torch.from_numpy(valid)


@pytest.mark.parametrize("b,p,lengths,grid", [
    (512, 1024, np.arange(512) * 7 % 1025, None),   # stage-1 shape
    (8, 16384, np.full(8, 16384), None),            # largest cap bucket
    (64, 1000, np.arange(64) * 16 % 1001, None),    # P not a multiple of 32
    (64, 256, np.arange(64) % 66, None),            # 0, 1 and < k valid
    (64, 1024, np.full(64, 1024), 2),               # duplicate points
])
def test_fps_kernel_matches_plain(b, p, lengths, grid):
    dev = _card()
    pts, valid = _fps_case(b, p, lengths, grid=grid)
    pts, valid = pts.to(dev), valid.to(dev)
    before = cuda_fps.launches
    got = masked_fps(pts, valid, 64)
    assert cuda_fps.launches == before + 1
    want = masked_fps_plain(pts, valid, 64)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_fps_kernel_refuses_oversized_rows():
    dev = _card()
    pts = torch.zeros(1, 16385, 3, device=dev)
    with pytest.raises(ValueError):
        cuda_fps.masked_fps_cuda(pts, torch.ones(1, 16385, dtype=torch.bool, device=dev), 4)
