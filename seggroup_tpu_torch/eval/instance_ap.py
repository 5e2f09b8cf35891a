"""ScanNet-benchmark instance-segmentation AP (host-side numpy).

The benchmark's protocol: overlaps 0.5:0.95:0.05 plus 0.25, ground-truth
regions of at least 100 points, greedy confidence-ordered matching with
void and small-region ignore handling, and the benchmark's trapezoid
precision-recall integration. Ground-truth encoding: gt_id =
semantic_class_id * 1000 + instance_index; points whose semantic class is
not a valid instance class count as void.

A copy of seggroup_tpu/eval/instance_ap.py (numpy only): the same matches
give the same AP.
"""

from __future__ import annotations

import numpy as np

CLASS_LABELS = [
    "cabinet", "bed", "chair", "sofa", "table", "door", "window", "bookshelf",
    "picture", "counter", "desk", "curtain", "refrigerator", "shower curtain",
    "toilet", "sink", "bathtub", "otherfurniture",
]
VALID_CLASS_IDS = np.array([3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28,
                            33, 34, 36, 39])
OVERLAPS = np.append(np.arange(0.5, 0.95, 0.05), 0.25)
MIN_REGION_SIZE = 100


def assign_instances_for_scan(pred_masks, pred_labels, pred_confs, gt_ids):
    """pred_masks: (P, N) bool; pred_labels: (P,) nyu40 ids; pred_confs: (P,);
    gt_ids: (N,) = sem*1000 + inst. Returns per-class match records."""
    gt_instances = {label: [] for label in CLASS_LABELS}
    for gid in np.unique(gt_ids):
        sem = gid // 1000
        if sem not in VALID_CLASS_IDS:
            continue
        label = CLASS_LABELS[int(np.where(VALID_CLASS_IDS == sem)[0][0])]
        mask = gt_ids == gid
        gt_instances[label].append({
            "instance_id": int(gid), "vert_count": int(mask.sum()),
            "mask": mask, "matched_pred": [],
        })
    pred_instances = {label: [] for label in CLASS_LABELS}
    bool_void = ~np.isin(gt_ids // 1000, VALID_CLASS_IDS)
    for i in range(len(pred_labels)):
        sem = int(pred_labels[i])
        if sem not in VALID_CLASS_IDS:
            continue
        label = CLASS_LABELS[int(np.where(VALID_CLASS_IDS == sem)[0][0])]
        mask = pred_masks[i]
        vert_count = int(mask.sum())
        if vert_count < MIN_REGION_SIZE:
            continue
        rec = {
            "uid": f"p{i}", "confidence": float(pred_confs[i]),
            "vert_count": vert_count,
            "void_intersection": int((mask & bool_void).sum()),
            "matched_gt": [],
        }
        for gt in gt_instances[label]:
            inter = int((mask & gt["mask"]).sum())
            if inter > 0:
                gt_rec = {"intersection": inter, "vert_count": gt["vert_count"],
                          "instance_id": gt["instance_id"]}
                rec["matched_gt"].append(gt_rec)
                gt["matched_pred"].append({
                    "intersection": inter, "vert_count": vert_count,
                    "confidence": rec["confidence"], "uid": rec["uid"],
                })
        pred_instances[label].append(rec)
    # strip masks (memory) — counts retained
    for label in gt_instances:
        for gt in gt_instances[label]:
            del gt["mask"]
    return {"gt": gt_instances, "pred": pred_instances}


def evaluate_matches(matches: list[dict]) -> np.ndarray:
    """matches: list of per-scene dicts from assign_instances_for_scan.
    Returns (num_classes, num_overlaps) AP array."""
    ap = np.zeros((len(CLASS_LABELS), len(OVERLAPS)))
    for oi, overlap_th in enumerate(OVERLAPS):
        pred_visited = {}
        for m in matches:
            for label in CLASS_LABELS:
                for p in m["pred"][label]:
                    pred_visited[p["uid"]] = False
        for li, label in enumerate(CLASS_LABELS):
            y_true, y_score = [], []
            hard_false_negatives = 0
            has_gt = has_pred = False
            for m in matches:
                preds = m["pred"][label]
                gts = [g for g in m["gt"][label]
                       if g["vert_count"] >= MIN_REGION_SIZE]
                has_gt |= bool(gts)
                has_pred |= bool(preds)

                cur_true, cur_score, cur_match = [], [], []
                for gt in gts:
                    found = False
                    matched_score = None
                    for pred in gt["matched_pred"]:
                        if pred_visited[pred["uid"]]:
                            continue
                        overlap = pred["intersection"] / (
                            gt["vert_count"] + pred["vert_count"]
                            - pred["intersection"])
                        if overlap > overlap_th:
                            conf = pred["confidence"]
                            if found:
                                hi = max(matched_score, conf)
                                lo = min(matched_score, conf)
                                matched_score = hi
                                cur_true.append(0)
                                cur_score.append(lo)
                            else:
                                found = True
                                matched_score = conf
                                pred_visited[pred["uid"]] = True
                    if found:
                        cur_true.append(1)
                        cur_score.append(matched_score)
                    else:
                        hard_false_negatives += 1

                for pred in preds:
                    found_gt = False
                    for gt in pred["matched_gt"]:
                        overlap = gt["intersection"] / (
                            gt["vert_count"] + pred["vert_count"]
                            - gt["intersection"])
                        if overlap > overlap_th:
                            found_gt = True
                            break
                    if not found_gt:
                        num_ignore = pred["void_intersection"]
                        for gt in pred["matched_gt"]:
                            if gt["vert_count"] < MIN_REGION_SIZE:
                                num_ignore += gt["intersection"]
                        if num_ignore / pred["vert_count"] <= overlap_th:
                            cur_true.append(0)
                            cur_score.append(pred["confidence"])
                y_true += cur_true
                y_score += cur_score

            if has_gt and has_pred:
                y_true = np.array(y_true)
                y_score = np.array(y_score)
                order = np.argsort(y_score)
                y_true = y_true[order]
                y_score = y_score[order]
                cum = np.cumsum(y_true)
                thresholds, unique_idx = np.unique(y_score, return_index=True)
                num = len(y_score)
                num_true = cum[-1] if len(cum) else 0
                precision = np.zeros(len(unique_idx) + 1)
                recall = np.zeros(len(unique_idx) + 1)
                cum_pad = np.append(cum, 0)
                for r, s in enumerate(unique_idx):
                    c = cum_pad[s - 1]
                    tp = num_true - c
                    fp = num - s - tp
                    fn = c + hard_false_negatives
                    precision[r] = tp / (tp + fp)
                    recall[r] = tp / (tp + fn)
                precision[-1] = 1.0
                recall[-1] = 0.0
                rc = np.concatenate([[recall[0]], recall, [0.0]])
                step = np.convolve(rc, [-0.5, 0, 0.5], "valid")
                ap[li, oi] = float(np.dot(precision, step))
            elif has_gt:
                ap[li, oi] = 0.0
            else:
                ap[li, oi] = np.nan
    return ap


def compute_averages(aps: np.ndarray) -> dict:
    o50 = np.isclose(OVERLAPS, 0.5)
    o25 = np.isclose(OVERLAPS, 0.25)
    main = ~o25
    out = {
        "all_ap": float(np.nanmean(aps[:, main])),
        "all_ap_50%": float(np.nanmean(aps[:, o50])),
        "all_ap_25%": float(np.nanmean(aps[:, o25])),
        "classes": {},
    }
    for li, label in enumerate(CLASS_LABELS):
        out["classes"][label] = {
            "ap": float(np.nanmean(aps[li, main])),
            "ap50%": float(np.nanmean(aps[li, o50])),
            "ap25%": float(np.nanmean(aps[li, o25])),
        }
    return out


def non_max_suppression(ious: np.ndarray, scores: np.ndarray,
                        threshold: float = 0.3) -> np.ndarray:
    """Greedy matrix NMS (reference pointgroup/test.py:194-204)."""
    order = np.argsort(-scores)
    keep = []
    suppressed = np.zeros(len(scores), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        suppressed |= ious[i] > threshold
    return np.array(keep, np.int64)
