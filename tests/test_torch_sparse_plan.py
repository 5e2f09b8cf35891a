"""The port's pyramid plans (seggroup_tpu_torch/sparse/{plan,device_plan,
merge_join}.py and the plan paths of sparse/conv.py) against the JAX
package's, on the CPU: host plans bit-equal to JAX's host plans (rulebooks,
down maps, window layouts, use_window), the device plan bit-equal to the
host plan (a saturated capacity and the window_levels structure
included), the windowed merge join equal to JAX's output for output (a
forced overflow with ok false included), the assume_sorted rulebook equal
to the searched one and to JAX's (where JAX's join overflows too), the
wire's round trip and range errors, and each plan's windows decoding to
its rulebooks. Capacities 2,048 to 8,192:
the smallest that take the merge-join and windowed branches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.sparse.conv import build_subm_rulebook as jax_build_subm_rulebook
from seggroup_tpu.sparse.merge_join import windowed_join3 as jax_windowed_join3
from seggroup_tpu.sparse.plan import build_unet_plan as jax_build_unet_plan
from seggroup_tpu.sparse.tensor import SparseTensor as JaxSparseTensor
from seggroup_tpu_torch.sparse import conv as tconv
from seggroup_tpu_torch.sparse.device_plan import (build_unet_plan_device, pack_voxel_batch,
                                                   unpack_voxel_batch)
from seggroup_tpu_torch.sparse.merge_join import windowed_join3
from seggroup_tpu_torch.sparse.plan import build_unet_plan, plan_to_device
from seggroup_tpu_torch.sparse.tensor import SparseTensor

BIG = np.iinfo(np.int32).max


def sorted_voxels(rng, cap, n, grid, batches=2):
    """n unique (b, x, y, z) rows in lexicographic order, zero padding to cap."""
    keys = np.sort(rng.choice(batches * grid ** 3, size=n, replace=False))
    b, r = np.divmod(keys, grid ** 3)
    x, r = np.divmod(r, grid ** 2)
    y, z = np.divmod(r, grid)
    coords = np.zeros((cap, 4), np.int32)
    coords[:n] = np.stack([b, x, y, z], 1)
    return coords


def torch_st(coords, n):
    cap = len(coords)
    return SparseTensor(torch.from_numpy(coords), torch.zeros((cap, 1)),
                        torch.arange(cap) < n, torch.tensor(n, dtype=torch.int32))


# (cap, n, grid, level caps, window_levels)
PLANS = {
    "minkunet_8192": (8192, 8192 - 117, 40, (8192, 4096, 2048, 1024, 1024), None),
    "minkunet_2048": (2048, 1900, 24, (2048, 1024, 512, 256, 256), None),
    "pointgroup_4096_wl0": (4096, 3000, 30, tuple(4096 >> i for i in range(7)), 0),
    "pointgroup_4096_wl3": (4096, 3000, 30, tuple(4096 >> i for i in range(7)), 3),
    "saturated_4096": (4096, 4096, 40, (4096, 2048, 1024), None),
    "sparse_4096": (4096, 2500, 200, (4096, 2048, 1024), None),
}


@pytest.fixture(scope="module")
def plans():
    """Per case: (coords, n, port host plan, JAX host plan, port device plan)."""
    out = {}
    for i, (name, (cap, n, grid, caps, wl)) in enumerate(sorted(PLANS.items())):
        coords = sorted_voxels(np.random.default_rng(i), cap, n, grid)
        host = build_unet_plan(coords, n, list(caps), window_levels=wl)
        ref = jax_build_unet_plan(coords, n, list(caps), window_levels=wl)
        dev = build_unet_plan_device(torch.from_numpy(coords), n, caps, window_levels=wl)
        out[name] = (coords, n, host, ref, dev)
    return out


def assert_plans_equal(a, b, what):
    assert len(a["rulebooks"]) == len(b["rulebooks"])
    for lvl, (x, y) in enumerate(zip(a["rulebooks"], b["rulebooks"])):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"{what}: rulebook {lvl}")
        assert np.asarray(x).dtype == np.int32
    assert len(a["down"]) == len(b["down"])
    for lvl, (x, y) in enumerate(zip(a["down"], b["down"])):
        assert int(x["num"]) == int(y["num"]), (what, lvl)
        for k in ("coords", "out_row", "delta"):
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]),
                                          err_msg=f"{what}: down {lvl} {k}")
    assert len(a["windows"]) == len(b["windows"])
    for lvl, (x, y) in enumerate(zip(a["windows"], b["windows"])):
        assert (x is None) == (y is None), (what, lvl)
        if x is None:
            continue
        assert bool(x["use_window"]) == bool(y["use_window"]), (what, lvl)
        for k in ("rb_win", "win_base"):
            np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]),
                                          err_msg=f"{what}: windows {lvl} {k}")


@pytest.mark.parametrize("name", sorted(PLANS))
def test_host_plan_equals_jax(plans, name):
    _, _, host, ref, _ = plans[name]
    assert_plans_equal(host, ref, name)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_device_plan_equals_host_plan(plans, name):
    _, _, host, _, dev = plans[name]
    assert_plans_equal(dev, host, name)


def test_window_levels_structure(plans):
    for name in ("pointgroup_4096_wl0", "pointgroup_4096_wl3", "minkunet_8192"):
        wl = PLANS[name][4]
        for plan in plans[name][2:]:
            for lvl, w in enumerate(plan["windows"]):
                cap = len(np.asarray(plan["rulebooks"][lvl]))
                want = (wl is None or lvl < wl) and cap % 256 == 0 and cap >= 2048
                assert (w is not None) == want, (name, lvl)
    assert all(w is None for w in plans["pointgroup_4096_wl0"][2]["windows"])


@pytest.mark.parametrize("name", sorted(PLANS))
def test_windows_decode_to_rulebooks(plans, name):
    _, _, _, _, dev = plans[name]
    decoded = 0
    for rb, w in zip(dev["rulebooks"], dev["windows"]):
        if w is None or not bool(w["use_window"]):
            continue
        np.testing.assert_array_equal(
            tconv.windows_to_rulebook(w["rb_win"], w["win_base"]).numpy(), rb.numpy())
        decoded += 1
    assert decoded == sum(w is not None for w in dev["windows"])


def test_window_overflow_and_its_decoding():
    """Rows out of lexicographic order: neighbours miss their windows,
    use_window is false on both sides, and the decoding differs from the
    rulebook exactly at the entries that did not fit."""
    rng = np.random.default_rng(9)
    cap = 2048
    coords = sorted_voxels(rng, cap, cap, 20)
    perm = rng.permutation(cap)
    rb = tconv.build_subm_rulebook(torch_st(np.ascontiguousarray(coords[perm]), cap), 3).numpy()
    from seggroup_tpu import native as jax_native
    from seggroup_tpu_torch.sparse.device_plan import build_windows_device

    w = build_windows_device(torch.from_numpy(rb))
    base, rb_win, ovf = jax_native.subm_windows(rb, 256, 512)
    assert ovf > 0 and not bool(w["use_window"])
    np.testing.assert_array_equal(w["rb_win"].numpy(), rb_win)
    np.testing.assert_array_equal(w["win_base"].numpy(), base)
    dec = tconv.windows_to_rulebook(w["rb_win"], w["win_base"]).numpy()
    assert int((dec != rb).sum()) == ovf


def _join_case(seed, m=1024, n_valid=900, hi_span=50, lo_span=30):
    rng = np.random.default_rng(seed)
    hi = np.sort(rng.integers(0, hi_span, n_valid).astype(np.int32))
    lo = np.zeros(n_valid, np.int32)
    for v in np.unique(hi):
        idx = np.where(hi == v)[0]
        lo[idx] = np.sort(rng.choice(lo_span, size=len(idx), replace=False))
    kh = np.full(m, BIG, np.int32)
    kl = np.full(m, BIG, np.int32)
    kh[:n_valid], kl[:n_valid] = hi, lo
    qh = np.where(kh != BIG, kh + 1, BIG).astype(np.int32)
    ql = np.where(kh != BIG, kl - 1, BIG - 4).astype(np.int32)
    return kh, kl, qh, ql


def _overflow_case():
    m = 1024
    return (np.zeros(m, np.int32), np.arange(m, dtype=np.int32), np.zeros(m, np.int32),
            np.arange(m, dtype=np.int32) - 1)


@pytest.mark.parametrize("case,tile,kw", [("seed0", 64, 128), ("seed1", 64, 128),
                                          ("seed0_t512", 512, 1024), ("overflow", 256, 64)])
def test_windowed_join3_equals_jax(case, tile, kw):
    args = _overflow_case() if case == "overflow" else _join_case(int(case[4]))
    want = jax_windowed_join3(*(jnp.asarray(a) for a in args), tile=tile, kw=kw)
    got = windowed_join3(*(torch.from_numpy(a) for a in args), tile=tile, kw=kw)
    assert bool(got[3]) == bool(want[3]) == (case != "overflow")
    for g, w in zip(got[:3], want[:3]):  # every position, the overflow's too
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def rulebook_case():
    rng = np.random.default_rng(2)
    cap = 4096
    pts = rng.integers(0, 40, size=(3500, 3)).astype(np.int32)
    b = rng.integers(0, 2, size=(3500, 1)).astype(np.int32)
    coords = np.unique(np.concatenate([b, pts], 1), axis=0)
    n = len(coords)
    full = np.zeros((cap, 4), np.int32)
    full[:n] = coords
    ref = np.asarray(jax.jit(lambda c: jax_build_subm_rulebook(
        JaxSparseTensor(c, jnp.zeros((cap, 1)), jnp.arange(cap) < n, jnp.int32(n)), 3,
        assume_sorted=True))(jnp.asarray(full)))
    return full, n, ref


def test_assume_sorted_rulebook_equals_searched_and_jax(rulebook_case):
    full, n, ref = rulebook_case
    st = torch_st(full, n)
    joined = tconv.build_subm_rulebook(st, 3, assume_sorted=True)
    searched = tconv.build_subm_rulebook(st, 3)
    np.testing.assert_array_equal(joined.numpy(), searched.numpy())
    np.testing.assert_array_equal(joined.numpy(), ref)


def test_assume_sorted_falls_back_on_overflow():
    """Where JAX's merge join overflows (a sparse column beside a dense one)
    and its lax.cond falls back to the searched path, the port's
    assume_sorted rulebook still equals JAX's."""
    from seggroup_tpu.sparse.conv import _k3_cols_joined as jax_cols_joined
    from seggroup_tpu.sparse.hashing import pack_keys as jax_pack_keys

    cap = 6144
    sparse_col = [(0, 0, y, 0) for y in range(512)]
    dense_col = [(0, 1, y, z) for y in range(512) for z in range(10)]
    coords = np.zeros((cap, 4), np.int32)
    n = len(sparse_col) + len(dense_col)
    coords[:n] = np.asarray(sparse_col + dense_col, np.int32)
    js = JaxSparseTensor(jnp.asarray(coords), jnp.zeros((cap, 1)), jnp.arange(cap) < n,
                         jnp.int32(n))
    hi, lo = jax_pack_keys(js.coords)
    _, ok = jax_cols_joined(js, jnp.where(js.valid, hi, BIG), jnp.where(js.valid, lo, BIG), 512)
    assert not bool(ok)
    ref = np.asarray(jax.jit(lambda s: jax_build_subm_rulebook(s, 3, assume_sorted=True))(js))
    rb = tconv.build_subm_rulebook(torch_st(coords, n), 3, assume_sorted=True)
    np.testing.assert_array_equal(rb.numpy(), ref)


def test_pack_unpack_roundtrip_and_range_errors():
    from seggroup_tpu.data.voxel_dataset import VoxelBatch
    from seggroup_tpu.sparse.device_plan import pack_voxel_batch as jax_pack

    rng = np.random.default_rng(4)
    cap, n = 256, 200
    coords = sorted_voxels(rng, cap, n, 9)
    feats = np.zeros((cap, 3), np.float32)
    feats[:n] = rng.normal(size=(n, 3))
    labels = np.full(cap, 255, np.int32)
    labels[:n] = rng.integers(0, 20, n)
    vb = VoxelBatch(coords, feats, labels, np.arange(cap) < n, np.int32(n), [])
    wire = pack_voxel_batch(vb)
    for got, want in zip(wire, jax_pack(vb)):
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)
    st, lab = unpack_voxel_batch(*wire, device="cpu")
    np.testing.assert_array_equal(st.coords.numpy(), coords)
    np.testing.assert_array_equal(lab.numpy(), labels)
    np.testing.assert_array_equal(st.valid.numpy(), np.arange(cap) < n)
    np.testing.assert_array_equal(st.feats.numpy(), feats.astype(np.float16).astype(np.float32))
    assert int(st.num) == n and st.feats.dtype == torch.float32

    for bad in (vb._replace(coords=np.where(np.arange(cap)[:, None] == 0, 32000, coords)),
                vb._replace(coords=np.where(np.arange(cap)[:, None] == 0, -32000, coords))):
        with pytest.raises(ValueError, match="int16 wire range"):
            pack_voxel_batch(bad)
    for lab in (256, -1):
        with pytest.raises(ValueError, match="uint8 wire range"):
            pack_voxel_batch(vb._replace(labels=np.where(np.arange(cap) == 3, lab, labels)))


def test_plan_to_device_keeps_structure(plans):
    host = plans["pointgroup_4096_wl3"][2]
    moved = plan_to_device(host, "cpu")
    assert moved["windows"][5] is None and moved["windows"][0]["use_window"].dtype == torch.bool
    assert_plans_equal(moved, host, "plan_to_device")


def test_strided_conv_down_planned_equals_jax(plans):
    """strided_conv_down_planned over a plan's first down map: the output
    and both gradients equal the port's strided_conv_down and, within
    1e-5, JAX's strided_conv_down_planned (float32)."""
    from seggroup_tpu.sparse.conv import strided_conv_down_planned as jax_down_planned

    coords, n, host, _, _ = plans["minkunet_2048"]
    cap = len(coords)
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(cap, 6)).astype(np.float32)
    w = (rng.normal(size=(8, 6, 5)) * 0.3).astype(np.float32)
    dout = rng.normal(size=(cap // 2, 5)).astype(np.float32)
    down = host["down"][0]

    def port(planned):
        f = torch.from_numpy(feats).requires_grad_(True)
        wt = torch.from_numpy(w).requires_grad_(True)
        st = torch_st(coords, n).with_feats(f)
        out, key = (tconv.strided_conv_down_planned(st, wt, plan_to_device(down, "cpu"))
                    if planned else tconv.strided_conv_down(st, wt, cap // 2))
        (out.feats * torch.from_numpy(dout)).sum().backward()
        return out.feats.detach().numpy(), f.grad.numpy(), wt.grad.numpy(), key["out_row"]

    planned, searched = port(True), port(False)
    for a, b in zip(planned, searched):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    js = JaxSparseTensor(jnp.asarray(coords), jnp.asarray(feats), jnp.arange(cap) < n,
                         jnp.int32(n))
    jdown = jax.tree.map(jnp.asarray, down)

    def jloss(wj, f):
        out, _ = jax_down_planned(js.with_feats(f), wj, jdown)
        return jnp.sum(out.feats * dout), out.feats

    (_, jout), (jgw, jgf) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(w), jnp.asarray(feats))
    for a, b in zip(planned[:3], (jout, jgf, jgw)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
