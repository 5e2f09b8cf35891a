"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `cuda`: without a card each test skips. The file imports no
JAX, so on a machine without it these run with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`."""

import numpy as np
import pytest
import torch

from seggroup_tpu_torch.ops import cuda_cc, cuda_fps, radius_cc
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


@pytest.mark.parametrize("m,cin,cout,kvol,layout", [
    (20000, 128, 128, 27, "empty_tiles"),   # whole 128-row tiles with no present offset
    (20000, 64, 64, 27, "last_offset"),      # tiles where only the last offset is present
    (20000, 96, 48, 1, "dense"),             # K = 1, N <= 64: no weights pass (direct)
    (20000, 160, 80, 1, "dense"),            # K = 1, N = 80: with the weights pass
    (20000, 3, 32, 125, "dense"),            # K = 125 (conv1_kernel_size=5)
    (20000, 80, 80, 27, "dense"),            # a stage crosses an offset boundary
    (20000, 6, 16, 27, "dense"),             # Cin padded from 6 to 8
    (8192, 256, 384, 27, "dense"),           # Cout = 384: two N tiles
    (131072, 384, 256, 27, "dense"),         # the warp-specialised kernel at full width
])
def test_subm_conv_kernel_edge_cases(m, cin, cout, kvol, layout):
    """K2 against its plain version (1e-4 of max|plain|), bit-equal across
    two runs, and exactly 0 on rows and tiles without any neighbour."""
    dev = _card()
    rng = np.random.default_rng(m + cin + kvol)
    rb = rng.integers(0, m, size=(m, kvol)).astype(np.int32)
    rb[rng.random((m, kvol)) < 0.5] = m
    rb[:100] = m
    if layout == "empty_tiles":
        rb[128 * 10:128 * 40] = m
        rb[128 * 50:128 * 51] = -7  # any value outside [0, M) is absent
    if layout == "last_offset":
        rb[128 * 10:128 * 40, :-1] = m
    f = torch.from_numpy(rng.normal(size=(m, cin)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.normal(size=(kvol, cin, cout)) / np.sqrt(kvol * cin))
                         .astype(np.float32)).to(torch.bfloat16)
    f, w, rb = f.to(dev), w.to(dev), torch.from_numpy(rb).to(dev)
    before = cuda_subm_conv.launches
    got = cuda_subm_conv.subm_conv_cuda(f, w, rb)
    again = cuda_subm_conv.subm_conv_cuda(f, w, rb)
    assert cuda_subm_conv.launches == before + 2
    # the plain version reads a zero pad row at M: absent neighbours as M
    lonely_pairs = (rb < 0) | (rb >= m)
    want = subm_conv_plain(f, w, torch.where(lonely_pairs, m, rb), torch.bfloat16)
    torch.cuda.synchronize()
    assert got.shape == (m, cout) and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert torch.equal(got, again)  # no atomics: the same bits on every run
    assert (got[lonely_pairs.all(1)] == 0).all()
    if layout == "empty_tiles":
        assert (got[128 * 10:128 * 40] == 0).all()


@pytest.mark.parametrize("kvol,cin,cout,view", [(27, 3, 32, False), (27, 96, 128, True),
                                                 (1, 40, 20, False), (125, 8, 32, False)])
def test_subm_conv_weights_pass_matches_plain(kvol, cin, cout, view):
    """K2's first pass (the weights into K-major order, zero padding) equals
    its plain version exactly, also on the data gradient's transposed view."""
    import ctypes

    dev = _card()
    g = torch.Generator().manual_seed(kvol + cin)
    if view:
        w = torch.randn(kvol, cout, cin, generator=g).to(torch.bfloat16).to(dev)
        w = w.flip(0).transpose(1, 2)
    else:
        w = torch.randn(kvol, cin, cout, generator=g).to(torch.bfloat16).to(dev)
    cin_p, cout_p = -(-cin // 8) * 8, -(-cout // 8) * 8
    lib = cuda_subm_conv._load()
    wt = torch.full((cout_p, kvol * cin_p), 7.0, dtype=torch.bfloat16, device=dev)
    err = lib.subm_conv_weights(ctypes.c_void_p(w.data_ptr()), ctypes.c_void_p(wt.data_ptr()),
                                kvol, cin, cout, cin_p, cout_p, *w.stride(),
                                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert err == 0
    torch.cuda.synchronize()
    assert torch.equal(wt, cuda_subm_conv.weights_k_major_plain(w, cin_p, cout_p))


def test_subm_conv_kernel_refuses_float32():
    dev = _card()
    f, w, rb = (x.to(dev) for x in _subm_case(256, 8, 8))
    with pytest.raises(ValueError):
        cuda_subm_conv.subm_conv_cuda(f.float(), w, rb)


@pytest.mark.parametrize("m,cin,cout,holes", [
    (20000, 3, 32, False),      # the stem, Cin padded to 8: K3b shift 2
    (20000, 32, 64, False),     # K3b shift 2, the wide Cout tile
    (20003, 64, 64, False),     # K3b shift 1, M not a multiple of a slab
    (20000, 128, 96, False),    # K3a, Cout 96 in a 128-wide tile
    (8192, 384, 256, False),    # K3a, the widest
    (5000, 40, 20, False),      # Cin and Cout not multiples of 8 (padded)
    (300, 96, 96, False),       # one slab: no second pass
    (40000, 128, 256, True),    # whole slabs without an offset, one offset nowhere
])
def test_subm_dw_kernel_matches_plain(m, cin, cout, holes):
    dev = _card()
    f, _, rb = (x.to(dev) for x in _subm_case(m, cin, cout))
    if holes:
        rb[: m // 2, 3] = m
        rb[:, 9] = m
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
    if holes:
        assert (got[9] == 0).all()


@pytest.mark.parametrize("m,slabs,slab_rows,absent", [
    (20003, 10, 2001, 0.85),    # ragged: the last slab holds 1,994 rows
    (131072, 8, 16384, 0.5),    # the longest slabs
    (300, 1, 300, 0.3),         # one slab
    (40000, 20, 2000, 0.5),     # whole slabs without an offset
])
def test_subm_dw_compaction_matches_plain(m, slabs, slab_rows, absent):
    """The kernel's compaction pass equals compact_pairs_plain exactly: the
    counts, and the pairs of each segment up to its count."""
    dev = _card()
    rb = _subm_case(m, 8, 8, seed=m, absent=absent)[2].to(dev)
    rb[: m // 2, 3] = m
    rb[:, 9] = -1  # any value outside [0, M) is absent
    pairs, counts = cuda_subm_dw.compact_pairs_cuda(rb, slabs, slab_rows)
    want_pairs, want_counts = cuda_subm_dw.compact_pairs_plain(rb, slabs, slab_rows)
    torch.cuda.synchronize()
    assert torch.equal(counts, want_counts)
    assert (counts[:, 9] == 0).all()
    if slab_rows <= m // 2:  # the first slab lacks offset 3 wholly
        assert int(counts[0, 3]) == 0
    filled = torch.arange(slab_rows, device=dev)[None, None, :] < counts[:, :, None]
    assert torch.equal(pairs[filled], want_pairs[filled])


def test_subm_dw_slab_sum_adds_in_order():
    """The slab-sum pass gives the bits of adding the slabs one after the
    other, in order."""
    dev = _card()
    g = torch.Generator().manual_seed(3)
    ws = (torch.randn(7, 27, 40, 24, generator=g) * 10 ** torch.randn(7, 1, 1, 1, generator=g))
    ws = ws.to(dev)
    want = ws[0].clone()
    for t in range(1, ws.shape[0]):
        want = want + ws[t]
    assert torch.equal(cuda_subm_dw.sum_slabs_cuda(ws), want)


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


def _cc_case(n_cap, n, seed, blobs=12, batches=2, spread=4.0):
    rng = np.random.default_rng(seed)
    coords = np.zeros((n_cap, 3), np.float32)
    centers = rng.uniform(-spread, spread, (blobs, 3))
    which = rng.integers(0, blobs, n)
    coords[:n] = centers[which] + rng.normal(0, 0.05, (n, 3))
    batch = np.zeros(n_cap, np.int32)
    batch[:n] = rng.integers(0, batches, blobs)[which]
    sem = np.zeros(n_cap, np.int32)
    sem[:n] = rng.integers(2, 8, blobs)[which]
    valid = np.zeros(n_cap, bool)
    valid[:n] = True
    return tuple(torch.from_numpy(x) for x in (coords, batch, valid, sem))


@pytest.mark.parametrize("n_cap,n,radius,tile", [
    (2048, 1500, 0.12, 256),     # the CPU tests' scene
    (16384, 16000, 0.05, 256),   # 64 tiles, ranges over several chunks
    (16384, 1000, 0.12, 256),    # valid rows end inside the fourth tile
    (4096, 0, 0.12, 256),        # no valid row
    (8192, 8000, 0.05, 128),     # another tile size
])
def test_cc_sweep_kernel_matches_plain(n_cap, n, radius, tile):
    """One sweep and the fixpoint: K4's labels equal the plain version's,
    and two runs of the kernel give the same bits."""
    dev = _card()
    coords, batch, valid, sem = (x.to(dev) for x in _cc_case(n_cap, n, seed=n))
    r = torch.tensor(radius, dtype=torch.float32, device=dev)
    prep = radius_cc._prep(coords, r, batch, valid, sem, tile, 1024)
    assert bool(prep.use_window)
    lab = torch.where(valid[prep.order.long()],
                      torch.arange(n_cap, dtype=torch.int32, device=dev), n_cap)
    before = cuda_cc.launches
    got = radius_cc.sweep(lab, prep, r * r, tile)
    assert cuda_cc.launches == before + 1
    want = radius_cc.sweep_plain(lab, prep, r * r, tile)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(got, radius_cc.sweep(lab, prep, r * r, tile))
    fix = radius_cc._cc_loop(prep, r * r, valid, tile=tile)
    fix_plain = radius_cc._cc_loop(prep, r * r, valid, tile=tile,
                                   sweep_fn=radius_cc.sweep_plain)
    assert torch.equal(fix, fix_plain) and bool((fix[~valid] == n_cap).all())


def test_semantic_radius_cc_on_card_matches_cpu():
    dev = _card()
    case = _cc_case(4096, 3500, seed=3)
    on_cpu = radius_cc.semantic_radius_cc(case[0], 0.12, *case[1:])
    before = cuda_cc.launches
    on_card = radius_cc.semantic_radius_cc(case[0].to(dev), 0.12,
                                           *(x.to(dev) for x in case[1:]))
    assert cuda_cc.launches > before
    assert torch.equal(on_card.cpu(), on_cpu)


def test_cc_sweep_kernel_refuses_what_it_cannot_launch():
    dev = _card()
    coords, batch, valid, sem = (x.to(dev) for x in _cc_case(2048, 1500, seed=1))
    r = torch.tensor(0.12, device=dev)
    prep = radius_cc._prep(coords, r, batch, valid, sem, 256, 1024)
    lab = torch.arange(2048, dtype=torch.int32, device=dev)
    args = (prep.xyz, prep.sem, prep.key, prep.lo, prep.hi, prep.offs, r * r)
    with pytest.raises(ValueError):
        cuda_cc.cc_sweep_cuda(lab.long(), *args, 256)  # int64 labels
    with pytest.raises(ValueError):
        cuda_cc.cc_sweep_cuda(lab, *args, 100)  # a tile that is no multiple of 32
    with pytest.raises(ValueError):
        cuda_cc.cc_sweep_cuda(lab.cpu(), *args, 256)  # a CPU tensor
