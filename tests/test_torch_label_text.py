"""The label files' text (seggroup_tpu_torch/native.format_int_lines): the
native library and its numpy fallback each give the bytes of Python's
"\\n".join(map(str, labels.tolist())) + "\\n", byte for byte, for every
int64, int32 input, strided views and gathered arrays. No JAX."""

from __future__ import annotations

import shutil

import numpy as np
import pytest

from seggroup_tpu_torch import native

I64 = np.iinfo(np.int64)


def _seeded(n=150_528, seed=0):
    """A bench scene's worth of labels in [-1, 600), as the instance files
    hold them (-1 for points of no instance)."""
    return np.random.default_rng(seed).integers(-1, 600, n)


def _unmap_gathered():
    rng = np.random.default_rng(1)
    labels = _seeded(4096, seed=2)
    unmap = rng.integers(0, len(labels), 6000)  # mesh vertex -> resampled point
    return labels[unmap]


CASES = {
    "empty": np.array([], np.int64),
    "one": np.array([7], np.int64),
    "zero": np.array([0], np.int64),
    "minus_one": np.array([-1], np.int64),
    "digit_boundaries": np.array([9, 10, 99, 100, -9, -10, -99, -100, 999, 1000], np.int64),
    "int64_min": np.array([I64.min], np.int64),
    "int64_max": np.array([I64.max], np.int64),
    "int64_extremes": np.array([I64.min, -1, 0, I64.max, I64.min + 1, I64.max - 1], np.int64),
    "every_width": np.concatenate([np.array([10 ** k, 10 ** k - 1, -(10 ** k), 1 - 10 ** k],
                                            np.int64) for k in range(19)]),
    "random_int64": np.random.default_rng(3).integers(I64.min, I64.max, 20_000, np.int64,
                                                      endpoint=True),
    "seeded_labels": _seeded(),
    "seeded_labels_int32": _seeded().astype(np.int32),
    "int32_extremes": np.array([np.iinfo(np.int32).min, -1, 0, np.iinfo(np.int32).max], np.int32),
    "strided_view": _seeded()[::2],
    "strided_view_int32": _seeded().astype(np.int32)[::3],
    "unmap_gathered": _unmap_gathered(),
}


def _want(a: np.ndarray) -> bytes:
    return ("\n".join(map(str, a.tolist())) + "\n").encode()


def _library_or_skip():
    if shutil.which("c++") is None and shutil.which("g++") is None:
        pytest.skip("no host C++ compiler: the library cannot be built")
    assert native.available(), native.load_error()


@pytest.mark.parametrize("case", sorted(CASES))
def test_library_writes_pythons_text(case):
    _library_or_skip()
    a = CASES[case]
    assert native.format_int_lines(a) == _want(a)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fallback_writes_pythons_text(case):
    a = CASES[case]
    with native.numpy_fallbacks():
        assert not native.available()
        assert native.format_int_lines(a) == _want(a)


def test_input_is_left_as_it_was():
    a = _seeded(1000)[::2]
    before = a.copy()
    native.format_int_lines(a)
    with native.numpy_fallbacks():
        native.format_int_lines(a)
    np.testing.assert_array_equal(a, before)


def test_a_table_is_refused():
    with pytest.raises(ValueError, match="1-D"):
        native.format_int_lines(np.zeros((2, 3), np.int64))
