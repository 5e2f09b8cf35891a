"""Host-side pieces of kernel K3 (seggroup_tpu_torch/sparse/cuda_subm_dw.py)
on the CPU: the compaction pass's plain version against a numpy oracle,
and the slab planner at Res16UNet34C's shapes. The kernel itself is held
against both on the card (tests/test_torch_cuda.py)."""

import math

import numpy as np
import pytest
import torch

from seggroup_tpu_torch.sparse import cuda_subm_dw

# every (Cin, Cout) of Res16UNet34C's submanifold convs (the stem's Cin of 3
# padded to 8, as the kernel's wrapper pads it), at the row capacity of
# each level of the training driver's 2^17 voxels
RES16UNET34C = [((8, 32), 2 ** 17), ((32, 32), 2 ** 17), ((32, 64), 2 ** 16),
                ((64, 64), 2 ** 16), ((64, 128), 2 ** 15), ((128, 128), 2 ** 15),
                ((128, 256), 2 ** 14), ((256, 256), 2 ** 14), ((384, 256), 2 ** 15),
                ((192, 128), 2 ** 16), ((128, 96), 2 ** 17), ((96, 96), 2 ** 17)]


def _oracle(rb: np.ndarray, slabs: int, slab_rows: int):
    """Per (slab, offset): the present (row, neighbour) pairs in ascending
    row order, row by row."""
    m, kvol = rb.shape
    out = {}
    for s in range(slabs):
        for k in range(kvol):
            rows = range(s * slab_rows, min(m, (s + 1) * slab_rows))
            out[s, k] = [(i, int(rb[i, k])) for i in rows if 0 <= rb[i, k] < m]
    return out


def _rulebook(m, kvol, absent, seed, negative=True):
    rng = np.random.default_rng(seed)
    rb = rng.integers(0, m, size=(m, kvol)).astype(np.int32)
    rb[rng.random((m, kvol)) < absent] = m
    if negative:  # any value outside [0, M) is absent to the compaction
        rb[rng.random((m, kvol)) < 0.05] = -3
    return rb


@pytest.mark.parametrize("m,kvol,slabs,slab_rows,absent", [
    (1000, 27, 4, 256, 0.5),     # ragged M: the last slab holds 232 rows
    (700, 27, 1, 768, 0.85),     # one slab, longer than M
    (2048, 27, 8, 256, 0.0),     # every neighbour present but the -3 ones
    (513, 1, 3, 256, 0.3),       # K = 1, a last slab of one row
])
def test_compact_pairs_plain_matches_oracle(m, kvol, slabs, slab_rows, absent):
    rb = _rulebook(m, kvol, absent, seed=m)
    if kvol > 1:
        rb[:, 5] = m            # an offset no row has
        rb[:slab_rows, 7] = m   # an offset the whole first slab lacks
        rb[100:200] = m         # rows without any neighbour
    pairs, counts = cuda_subm_dw.compact_pairs_plain(torch.from_numpy(rb), slabs, slab_rows)
    assert pairs.shape == (slabs, kvol, slab_rows, 2) and pairs.dtype == torch.int32
    assert counts.shape == (slabs, kvol) and counts.dtype == torch.int32
    want = _oracle(rb, slabs, slab_rows)
    for (s, k), seg in want.items():
        n = int(counts[s, k])
        assert n == len(seg), (s, k)
        np.testing.assert_array_equal(pairs[s, k, :n].numpy(),
                                      np.asarray(seg, np.int32).reshape(-1, 2))
        assert (pairs[s, k, n:] == -1).all()
    if kvol > 1:
        assert (counts[:, 5] == 0).all() and int(counts[0, 7]) == 0


def test_compacted_pairs_give_the_weight_gradient():
    """dW[k] summed over the compacted pairs of every slab equals the plain
    weight gradient over the rulebook: the pairs are all the product needs."""
    from seggroup_tpu_torch.sparse.conv import subm_dw_plain

    m, kvol, cin, cout = 900, 27, 8, 16
    rb = torch.from_numpy(_rulebook(m, kvol, 0.6, seed=2, negative=False))
    g = torch.Generator().manual_seed(0)
    f = torch.randn(m, cin, generator=g).to(torch.bfloat16)
    d = torch.randn(m, cout, generator=g).to(torch.bfloat16)
    pairs, counts = cuda_subm_dw.compact_pairs_plain(rb, 4, 256)
    dw = torch.zeros(kvol, cin, cout, dtype=torch.float64)
    for s in range(4):
        for k in range(kvol):
            p = pairs[s, k, :int(counts[s, k])].long()
            dw[k] += f[p[:, 1]].double().T @ d[p[:, 0]].double()
    want = subm_dw_plain(f, d, rb, torch.bfloat16)
    assert float((dw.float() - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("cin,cout", [c for c, _ in RES16UNET34C])
@pytest.mark.parametrize("sms", [132, 114])
def test_k3_slab_plan_at_res16unet34c_shapes(cin, cout, sms):
    """At each pair's level capacity and at a full 2^17 rows: the slabs
    cover the rows, none is longer than
    MAX_SLAB_ROWS, the partials stay under WORKSPACE_BYTES, and the grid
    holds CTAS_PER_SM CTAs per SM wherever MIN_SLAB_ROWS lets the rows be
    cut that fine."""
    level_rows = dict(RES16UNET34C)[(cin, cout)]
    tm, tn = cuda_subm_dw.tile(cin, cout)
    assert cin <= 32 and tm == 32 or 32 < cin <= 64 and tm == 64 or cin > 64 and tm == 128
    assert tn >= min(cout, 2 * tm) and (tn == 2 * tm or cout <= tn)
    per_slab = 27 * math.ceil(cin / tm) * math.ceil(cout / tn)
    for m in {level_rows, 2 ** 17}:
        slabs, rows = cuda_subm_dw.slabs_for(m, 27, cin, cout, sms)
        assert (slabs - 1) * rows < m <= slabs * rows
        assert rows <= cuda_subm_dw.MAX_SLAB_ROWS
        assert slabs * 27 * cin * cout * 4 <= cuda_subm_dw.WORKSPACE_BYTES
        finest = math.ceil(m / cuda_subm_dw.MIN_SLAB_ROWS)
        if finest * per_slab >= cuda_subm_dw.CTAS_PER_SM * sms:
            assert slabs * per_slab >= cuda_subm_dw.CTAS_PER_SM * sms
        else:
            assert slabs == finest and rows <= cuda_subm_dw.MIN_SLAB_ROWS


def test_compaction_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the card's passes raise: the plain version is the
    caller's to pick."""
    rb = torch.zeros((8, 27), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_subm_dw.compact_pairs_cuda(rb, 1, 256)
    with pytest.raises(ValueError):
        cuda_subm_dw.sum_slabs_cuda(torch.zeros(2, 4))
