"""Port segment reductions (seggroup_tpu_torch.ops.segment_ops) against the
JAX ones on the CPU. Float data are multiples of 1/8, so sums are exact in
any order and every comparison is equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.ops import segment_ops as J
from seggroup_tpu_torch.ops import segment_ops as T

torch.set_num_threads(1)

S = 7


def _case(seed, dtype, width):
    rng = np.random.default_rng(seed)
    n = 60
    shape = (n,) if width is None else (n, width)
    data = rng.integers(-100, 100, size=shape)
    data = (data / 8.0).astype(np.float32) if dtype == "float32" else data.astype(np.int32)
    # ids: in range except segment 3 (left empty), plus out-of-range padding
    ids = rng.choice([0, 1, 2, 4, 5, 6, -1, S, S + 5], size=n).astype(np.int32)
    return data, ids


def _both(op, data, ids, fill=None):
    jkw = {} if fill is None else {"fill_value": jnp.asarray(fill, data.dtype)}
    tkw = {} if fill is None else {"fill_value": fill}
    want = np.asarray(getattr(J, op)(jnp.asarray(data), jnp.asarray(ids), S, **jkw))
    got = getattr(T, op)(torch.from_numpy(data), torch.from_numpy(ids), S, **tkw).numpy()
    return want, got


@pytest.mark.parametrize("width", [None, 3])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
@pytest.mark.parametrize("op", ["segment_sum", "segment_mean", "segment_max",
                                "segment_min"])
def test_reduction_matches_jax(op, dtype, width):
    data, ids = _case(0, dtype, width)
    want, got = _both(op, data, ids)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (got[3] == 0).all()  # the empty segment gets the default fill


@pytest.mark.parametrize("op,fill", [("segment_max", -1), ("segment_min", 99)])
def test_fill_value_matches_jax(op, fill):
    data, ids = _case(1, "int32", None)
    want, got = _both(op, data, ids, fill=fill)
    np.testing.assert_array_equal(got, want)
    assert got[3] == fill


def test_float_fill_value_matches_jax():
    data, ids = _case(2, "float32", 4)
    want, got = _both("segment_min", data, ids, fill=1e30)
    np.testing.assert_array_equal(got, want)


def test_invert_permutation_matches_jax():
    order = np.random.default_rng(3).permutation(97).astype(np.int32)
    want = np.asarray(J.invert_permutation(jnp.asarray(order)))
    got = T.invert_permutation(torch.from_numpy(order)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
