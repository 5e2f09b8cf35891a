"""The port's copy of the ScanNet instance-AP evaluator
(seggroup_tpu_torch.eval.instance_ap) against the JAX package's: equal on
random predictions, and the known-answer cases of tests/test_instance_ap.py."""

import numpy as np
import pytest

from seggroup_tpu.eval import instance_ap as J
from seggroup_tpu_torch.eval import instance_ap as T
from test_instance_ap import make_scene


def _random_scene(seed, n=3000, n_pred=14):
    """Ground truth of valid, void and small regions; predictions that are
    noisy copies of instances, fragments and pure noise."""
    rng = np.random.default_rng(seed)
    gt = np.zeros(n, np.int64)
    cuts = np.sort(rng.choice(np.arange(50, n - 50), 9, replace=False))
    classes = rng.choice([1, 2, 3, 4, 5, 7, 8, 12, 39, 40], size=10)
    for k, (a, b) in enumerate(zip(np.r_[0, cuts], np.r_[cuts, n])):
        gt[a:b] = classes[k] * 1000 + k + 1
    masks, labels, confs = [], [], []
    ids = np.unique(gt)
    for _ in range(n_pred):
        base = gt == rng.choice(ids)
        flip = rng.random(n) < rng.choice([0.0, 0.1, 0.4])
        mask = base ^ flip if rng.random() < 0.8 else rng.random(n) < 0.1
        masks.append(mask)
        labels.append(int(rng.choice(classes)))
        confs.append(float(rng.choice([0.2, 0.5, 0.5, 0.9, rng.random()])))
    return gt, np.stack(masks), np.array(labels), np.array(confs)


@pytest.mark.parametrize("seed", range(6))
def test_evaluator_equals_jax_package_on_random_matches(seed):
    scenes = [_random_scene(seed * 10 + i) for i in range(3)]
    got = T.evaluate_matches([T.assign_instances_for_scan(m, l, c, gt)
                              for gt, m, l, c in scenes])
    want = J.evaluate_matches([J.assign_instances_for_scan(m, l, c, gt)
                               for gt, m, l, c in scenes])
    np.testing.assert_array_equal(got, want)  # nan where a class is absent in both
    assert got.shape == (18, 10) and np.isfinite(got).any()
    a, b = T.compute_averages(got), J.compute_averages(want)
    assert a.keys() == b.keys()
    np.testing.assert_equal(a, b)


def test_constants_equal_jax_package():
    assert T.CLASS_LABELS == J.CLASS_LABELS and T.MIN_REGION_SIZE == J.MIN_REGION_SIZE
    np.testing.assert_array_equal(T.VALID_CLASS_IDS, J.VALID_CLASS_IDS)
    np.testing.assert_array_equal(T.OVERLAPS, J.OVERLAPS)


@pytest.mark.parametrize("seed", range(3))
def test_nms_equals_jax_package(seed):
    rng = np.random.default_rng(seed)
    ious = rng.random((12, 12))
    ious = np.maximum(ious, ious.T)
    np.fill_diagonal(ious, 1.0)
    scores = rng.random(12)
    np.testing.assert_array_equal(T.non_max_suppression(ious, scores, 0.5),
                                  J.non_max_suppression(ious, scores, 0.5))


def test_perfect_predictions_give_ap1():
    gt = make_scene()
    masks = np.stack([gt == 5001, gt == 5002, gt == 4001])
    m = T.assign_instances_for_scan(masks, np.array([5, 5, 4]), np.array([0.9, 0.8, 0.95]), gt)
    avg = T.compute_averages(T.evaluate_matches([m]))
    assert avg["all_ap_50%"] == 1.0 and avg["all_ap"] == 1.0


def test_half_overlap_fails_high_thresholds():
    gt = make_scene()
    m1 = np.zeros(1000, bool)
    m1[:150] = True
    m2 = np.zeros(1000, bool)
    m2[300:400] = True
    masks = np.stack([m1, m2, gt == 4001])
    m = T.assign_instances_for_scan(masks, np.array([5, 5, 4]), np.array([0.9, 0.8, 0.95]), gt)
    aps = T.evaluate_matches([m])
    assert T.compute_averages(aps)["all_ap_25%"] == 1.0
    o50 = np.where(np.isclose(T.OVERLAPS, 0.5))[0][0]
    assert aps[2, o50] == 0.0  # chairs: IoU exactly 0.5 is not > 0.5


def test_void_overlap_is_not_fp():
    gt = make_scene()
    mv = np.zeros(1000, bool)
    mv[800:] = True
    masks = np.stack([gt == 5001, gt == 5002, gt == 4001, mv])
    m = T.assign_instances_for_scan(masks, np.array([5, 5, 4, 5]),
                                    np.array([0.9, 0.8, 0.95, 0.99]), gt)
    assert T.compute_averages(T.evaluate_matches([m]))["all_ap_50%"] == 1.0


def test_false_positive_lowers_ap():
    gt = make_scene()
    fp = np.zeros(1000, bool)
    fp[500:700] = True
    masks = np.stack([gt == 5001, gt == 5002, fp])
    m = T.assign_instances_for_scan(masks, np.array([5, 5, 5]), np.array([0.9, 0.8, 0.99]), gt)
    o50 = np.where(np.isclose(T.OVERLAPS, 0.5))[0][0]
    assert 0.0 < T.evaluate_matches([m])[2, o50] < 1.0


def test_nms():
    ious = np.array([[1.0, 0.9, 0.0], [0.9, 1.0, 0.0], [0.0, 0.0, 1.0]])
    keep = T.non_max_suppression(ious, np.array([0.5, 0.9, 0.7]), threshold=0.3)
    assert set(keep.tolist()) == {1, 2}
