"""Host-side pieces of kernel K2 (seggroup_tpu_torch/sparse/cuda_subm_conv.py)
on the CPU: the launch plan (entry point, N tile, ring depth, kernel) at
every pair the port's models run, the present-offset lists and the weights'
K-major order against numpy, and a float64 numpy model of the kernel's
reduction order (present offsets per 128-row tile, 8-channel pieces, stages
of 64 values) against the plain version. The kernel itself is held against
the plain version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from seggroup_tpu_torch.sparse import cuda_subm_conv as k2
from seggroup_tpu_torch.sparse.conv import subm_conv_plain

# every (Cin, Cout) of Res16UNet34C's submanifold convs at the row capacity
# of its level (the training driver's 2^17 voxels)
RES16UNET34C = [((3, 32), 2 ** 17), ((32, 32), 2 ** 17), ((32, 64), 2 ** 16),
                ((64, 64), 2 ** 16), ((64, 128), 2 ** 15), ((128, 128), 2 ** 15),
                ((128, 256), 2 ** 14), ((256, 256), 2 ** 14), ((384, 256), 2 ** 15),
                ((192, 128), 2 ** 16), ((128, 96), 2 ** 17), ((96, 96), 2 ** 17)]
# the data gradient runs K2 at (Cout, Cin) over the same rows, but the stem's
DGRAD = [((cout, cin), m) for (cin, cout), m in RES16UNET34C if cin != 3]
# PointGroup at m=16 over its 2^16 voxel rows: K = 27, and K = 1 after each
# concatenation
POINTGROUP = ([((6, 16), 27)] + [((16 * i, 16 * i), 27) for i in range(1, 8)]
              + [((32 * i, 16 * i), 27) for i in range(1, 7)]
              + [((32 * i, 16 * i), 1) for i in range(1, 7)])
CASES = ([(c, 27, m, "forward") for c, m in RES16UNET34C]
         + [(c, 27, m, "data gradient") for c, m in DGRAD]
         + [(c, k, 2 ** 16, "PointGroup") for c, k in POINTGROUP])


@pytest.mark.parametrize("pair,kvol,m,what", CASES,
                         ids=[f"{w}-{c[0]}x{c[1]}-K{k}" for c, k, _, w in CASES])
def test_plan_at_every_pair_of_the_models(pair, kvol, m, what):
    cin, cout = pair
    p = k2.plan(cin, cout, kvol, m)
    cout_p = -(-cout // 8) * 8
    assert p.entry == k2.regime(cin)
    assert p.n in k2.N_TILES and p.n * p.n_tiles >= cout_p
    assert p.n * (p.n_tiles - 1) < cout_p  # no N tile wholly in the padding
    most = -(-kvol * -(-cin // 8) // 8)  # stages of a tile with every offset present
    if most < k2.STAGES:  # the ring holds every stage
        assert p.stages == max(most, 2 if p.ws else 1)
    else:
        assert p.stages in (3, 4)
    assert p.smem == k2.smem_bytes(p.n, kvol, p.stages)
    assert p.smem <= k2.SMEM_LIMIT
    assert p.ws == int(p.n in k2.WS_N)
    # no weights pass only at K = 1 with a narrow N (not warp-specialised)
    assert p.direct == (kvol == 1 and p.n <= 64)
    assert not (p.direct and p.ws)
    row_tiles = -(-m // k2.ROW_TILE)
    if row_tiles >= 132 and cout_p <= 256:
        assert p.n_tiles == 1 and p.n == min(w for w in k2.N_TILES if w >= cout_p)
    if cout_p > 256:  # the data gradient's (256, 384): two equal tiles
        assert p.n_tiles == 2 and p.n == 192


def test_plan_splits_n_where_the_rows_do_not_fill_the_card():
    # level 3 of the bench scene: 16,384 rows, 128 row tiles
    p = k2.plan(384, 256, 27, 2 ** 14, sms=132)
    assert (p.n, p.n_tiles, p.stages, p.ws) == (128, 2, 4, 0)
    p = k2.plan(384, 256, 27, 2 ** 17, sms=132)
    assert (p.n, p.n_tiles, p.stages, p.ws) == (256, 1, 4, 1)
    # two CTAs on an SM where the grid covers the card more than twice
    assert k2.plan(128, 128, 27, 2 ** 17).stages == 3
    assert k2.plan(64, 64, 27, 2 ** 17).stages == 4


def test_plan_takes_large_kernels_and_refuses_what_does_not_fit():
    p = k2.plan(3, 32, 125, 2 ** 17)  # conv1_kernel_size=5
    assert p.smem <= k2.SMEM_LIMIT and p.stages in (3, 4)
    assert k2.plan(32, 16, 1, 2 ** 16).stages == 1  # K = 1: one stage, copied up front
    p = k2.plan(256, 256, 125, 2 ** 17)  # the rulebook block leaves room for 3 stages
    assert p.stages == 3 and p.smem <= k2.SMEM_LIMIT
    with pytest.raises(ValueError):
        k2.plan(256, 256, 343, 2 ** 17)  # a 7^3 kernel's block alone is 171.5 KB


def _rulebook(m, kvol, seed, absent=0.5):
    """Random neighbours with `absent` of them missing (M or -1), whole
    128-row tiles without any offset, a tile with the last offset alone,
    and rows without neighbours."""
    rng = np.random.default_rng(seed)
    rb = rng.integers(0, m, size=(m, kvol)).astype(np.int32)
    miss = rng.random((m, kvol)) < absent
    rb[miss] = np.where(rng.random(miss.sum()) < 0.5, m, -1)
    rb[128:384] = m
    if kvol > 1 and m > 512:
        rb[384:512, :-1] = m
    rb[5:9] = m
    return rb


def _tile_order_model(feats, w, rb):
    """The kernel's sum in float64: per 128-row tile, its present offsets
    in ascending k, each cut into 8-channel pieces, the flattened pieces cut
    into stages of 8 (64 values); out_tile += A_stage @ B_stage in stage
    order. Returns the output and the number of stages per tile."""
    m, cin_p = feats.shape
    kvol, _, cout = w.shape
    per_offset = cin_p // 8
    out = np.zeros((m, cout))
    stages = []
    for m0 in range(0, m, k2.ROW_TILE):
        nbr = rb[m0:m0 + k2.ROW_TILE]
        on = (nbr >= 0) & (nbr < m)
        present = [k for k in range(kvol) if on[:, k].any()]
        pieces = [(k, c) for k in present for c in range(per_offset)]
        stages.append(-(-len(pieces) // 8))
        for s in range(0, len(pieces), 8):
            a = np.zeros((len(nbr), 64))
            b = np.zeros((64, cout))
            for j, (k, c) in enumerate(pieces[s:s + 8]):
                rows = on[:, k]
                a[rows, 8 * j:8 * j + 8] = feats[nbr[rows, k], 8 * c:8 * c + 8]
                b[8 * j:8 * j + 8] = w[k, 8 * c:8 * c + 8]
            out[m0:m0 + k2.ROW_TILE] += a @ b
    return out, stages


@pytest.mark.parametrize("m,cin,cout,kvol", [
    (700, 3, 32, 27),     # the stem: Cin padded to 8, a stage packs 8 offsets
    (1000, 80, 48, 27),   # Cin = 80: stages cross offset boundaries
    (643, 32, 16, 27),    # 4 offsets a stage, a ragged last tile
    (300, 64, 40, 1),     # K = 1
    (600, 8, 24, 125),    # a 5^3 kernel
])
def test_tile_order_model_reproduces_the_plain_version(m, cin, cout, kvol):
    rng = np.random.default_rng(m + cin)
    rb = _rulebook(m, kvol, seed=m)
    feats = torch.from_numpy(rng.normal(size=(m, cin)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.normal(size=(kvol, cin, cout)) / np.sqrt(kvol * cin))
                         .astype(np.float32)).to(torch.bfloat16)
    want = subm_conv_plain(feats, w, torch.from_numpy(rb), torch.bfloat16).numpy()
    f64 = k2.pad8(feats, 1).float().numpy().astype(np.float64)
    w64 = k2.pad8(w, 1).float().numpy().astype(np.float64)
    got, stages = _tile_order_model(f64, w64, rb)
    # float64 against the plain version's float32 sums of the same products
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert (got[128:384] == 0).all() and (got[5:9] == 0).all()
    present = k2.present_offsets_plain(torch.from_numpy(rb)).numpy()
    per_offset = -(-cin // 8)
    assert stages == [-(-int(n) * per_offset // 8) for n in present.sum(1)]
    assert stages[1] == stages[2] == 0  # tiles without any offset: no stage


def test_present_offsets_match_numpy():
    m, kvol = 1000, 27
    rb = _rulebook(m, kvol, seed=3, absent=0.9)
    got = k2.present_offsets_plain(torch.from_numpy(rb)).numpy()
    on = (rb >= 0) & (rb < m)
    want = np.stack([on[i:i + 128].any(0) for i in range(0, m, 128)])
    assert got.shape == (8, kvol) and (got == want).all()
    assert not got[1].any() and not got[2].any()
    assert got[3].tolist() == [False] * (kvol - 1) + [True]


@pytest.mark.parametrize("kvol,cin,cout,view", [(27, 3, 32, False), (27, 40, 20, False),
                                                 (27, 96, 128, True), (1, 64, 32, True)])
def test_weights_k_major_plain(kvol, cin, cout, view):
    rng = np.random.default_rng(kvol + cin)
    w = torch.from_numpy(rng.normal(size=(kvol, cin, cout)).astype(np.float32))
    if view:  # the data gradient's weights: flipped and transposed, not contiguous
        w = torch.from_numpy(rng.normal(size=(kvol, cout, cin)).astype(np.float32))
        w = w.flip(0).transpose(1, 2)
    cin_p, cout_p = -(-cin // 8) * 8, -(-cout // 8) * 8
    got = k2.weights_k_major_plain(w, cin_p, cout_p).numpy()
    assert got.shape == (cout_p, kvol * cin_p)
    wn = w.numpy()
    for k in range(kvol):
        np.testing.assert_array_equal(got[:cout, k * cin_p:k * cin_p + cin], wn[k].T)
        assert (got[:, k * cin_p + cin:(k + 1) * cin_p] == 0).all()
    assert (got[cout:] == 0).all()
