"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`: without a card each test skips. The file imports no
JAX, so on a machine without it these run with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`."""

import numpy as np
import pytest
import torch

from seggroup_tpu_torch.ops import cuda_fps
from seggroup_tpu_torch.ops.fps import masked_fps, masked_fps_plain
from seggroup_tpu_torch.sparse import cuda_subm_conv, cuda_subm_dw
from seggroup_tpu_torch.sparse.conv import subm_conv_plain, subm_dw_plain

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


def _subm_case(m, cin, cout, seed=0, absent=0.85):
    """Random rulebook over m rows: each offset present with probability
    1 - absent, the first 100 rows with no neighbour at all."""
    rng = np.random.default_rng(seed)
    rb = rng.integers(0, m, size=(m, 27)).astype(np.int32)
    rb[rng.random((m, 27)) < absent] = m
    rb[:100] = m
    feats = rng.normal(size=(m, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    return (torch.from_numpy(feats).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16),
            torch.from_numpy(rb))


@pytest.mark.parametrize("m,cin,cout", [
    (20000, 3, 32),      # the stem, Cin padded to 8: K2c shift 2
    (20000, 32, 64),     # K2c shift 2
    (20003, 64, 64),     # K2c shift 1, M not a multiple of the row tile
    (20000, 96, 96),     # K2a/b, chunked Cin, Cout tile half used
    (8192, 384, 256),    # K2a/b, the widest
    (5000, 40, 20),      # Cin and Cout not multiples of 8 (padded)
])
def test_subm_conv_kernel_matches_plain(m, cin, cout):
    dev = _card()
    f, w, rb = (x.to(dev) for x in _subm_case(m, cin, cout))
    before = cuda_subm_conv.launches
    got = cuda_subm_conv.subm_conv_cuda(f, w, rb)
    assert cuda_subm_conv.launches == before + 1
    want = subm_conv_plain(f, w, rb, torch.bfloat16)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (m, cout)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert (got[:100] == 0).all()


def test_subm_conv_kernel_refuses_float32():
    dev = _card()
    f, w, rb = (x.to(dev) for x in _subm_case(256, 8, 8))
    with pytest.raises(ValueError):
        cuda_subm_conv.subm_conv_cuda(f.float(), w, rb)


@pytest.mark.parametrize("m,cin,cout", [
    (20000, 3, 32),      # the stem, Cin padded to 8: K3b shift 2
    (20000, 32, 64),     # K3b shift 2, two Cout tiles
    (20003, 64, 64),     # K3b shift 1, M not a multiple of the chunk
    (20000, 128, 96),    # K3a, Cout 96 in a 128-wide tile
    (8192, 384, 256),    # K3a, the widest
    (5000, 40, 20),      # Cin and Cout not multiples of 8 (padded)
    (300, 96, 96),       # one slab: no second pass
])
def test_subm_dw_kernel_matches_plain(m, cin, cout):
    dev = _card()
    f, _, rb = (x.to(dev) for x in _subm_case(m, cin, cout))
    g = torch.Generator().manual_seed(m)
    dout = torch.randn(m, cout, generator=g).to(dev).to(torch.bfloat16)
    before = cuda_subm_dw.launches
    got = cuda_subm_dw.subm_dw_cuda(f, dout, rb)
    assert cuda_subm_dw.launches == before + 1
    want = subm_dw_plain(f, dout, rb, torch.bfloat16)
    again = cuda_subm_dw.subm_dw_cuda(f, dout, rb)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (27, cin, cout)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert torch.equal(got, again)  # no atomics: the same bits on every run


def test_subm_conv_backward_on_card_matches_cpu():
    """dfeats through K2 (flipped, transposed weights) and dW through K3 on
    the card, against the plain versions on the CPU, at bf16."""
    from seggroup_tpu_torch.sparse.conv import subm_conv
    from seggroup_tpu_torch.sparse.tensor import SparseTensor

    dev = _card()
    m, cin, cout = 4096, 48, 40
    f, w, rb = _subm_case(m, cin, cout, absent=0.5)
    valid = torch.arange(m) < m - 50
    coords = torch.zeros((m, 4), dtype=torch.int32)
    grads = []
    for d in ("cpu", dev):
        feats = f.float().to(d).requires_grad_(True)
        weights = w.float().to(d).requires_grad_(True)
        st = SparseTensor(coords.to(d), feats, valid.to(d), torch.tensor(m - 50).to(d))
        out = subm_conv(st, weights, rb.to(d))
        (out * torch.linspace(-1, 1, cout, device=d)).sum().backward()
        grads.append((feats.grad.cpu(), weights.grad.cpu()))
    for (a, b), name in zip(zip(*grads), ("dfeats", "dW")):
        assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max()), name
    assert (grads[1][0][m - 50:] == 0).all()
