"""Port semantic metrics (seggroup_tpu_torch.eval.semantic) against the JAX
package's, whose average precision is scikit-learn's: the confusion matrix
and mIoU exactly, AP to 1e-12 (the same terms summed in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seggroup_tpu.eval import semantic as J
from seggroup_tpu_torch.eval import semantic as T

torch.set_num_threads(1)
C = 20


def _case(seed, n=5000, absent=(3, 17)):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, C, size=n).astype(np.int32)
    labels[np.isin(labels, absent)] = 0  # classes 3 and 17 never appear
    labels[rng.random(n) < 0.1] = 255    # ignored points
    pred = rng.integers(-2, C + 2, size=n).astype(np.int32)  # clipped on both sides
    logits = rng.normal(size=(n, C)).astype(np.float32)
    logits = np.round(logits * 4) / 4  # coarse: many tied scores
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return labels, pred, probs.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_confusion_and_miou_equal_jax(seed):
    labels, pred, _ = _case(seed)
    want = np.asarray(J.confusion_matrix(jnp.asarray(pred), jnp.asarray(labels), C))
    got = T.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(labels), C).numpy()
    np.testing.assert_array_equal(got, want)
    miou_w, iou_w = J.miou_from_confusion(want)
    miou_g, iou_g = T.miou_from_confusion(got)
    assert miou_g == miou_w
    np.testing.assert_array_equal(iou_g, iou_w)  # NaN where a class is absent


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_average_precision_equals_sklearn(seed):
    labels, _, probs = _case(seed)
    want = J.average_precision(probs, labels, C)
    got = T.average_precision(probs, labels, C)
    assert np.isnan(got[[3, 17]]).all()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12, equal_nan=True)


def test_average_precision_edge_cases():
    """All scores tied, one positive, every point positive."""
    labels = np.array([0, 1, 1, 0, 1, 255], np.int32)
    for probs in (np.full((6, 2), 0.5, np.float32),
                  np.array([[0.9, 0.1], [0.2, 0.8], [0.6, 0.4], [0.6, 0.4],
                            [0.3, 0.7], [0.5, 0.5]], np.float32)):
        np.testing.assert_allclose(T.average_precision(probs, labels, 2),
                                   J.average_precision(probs, labels, 2), rtol=1e-12)
    one = np.array([1, 0, 0, 0], np.int32)
    p = np.array([[0.2, 0.8], [0.9, 0.1], [0.5, 0.5], [0.1, 0.9]], np.float32)
    np.testing.assert_allclose(T.average_precision(p, one, 2),
                               J.average_precision(p, one, 2), rtol=1e-12)
