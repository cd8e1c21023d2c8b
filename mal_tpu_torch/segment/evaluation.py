"""COCO-style instance-segmentation evaluation (mask AP), numpy.

A copy of `mal_tpu.segment.evaluation`, held against it by
`tests/test_torch_seg_data.py`.

Standalone re-implementation of the metric the reference's evaluator stack
computes through detectron2's `COCOEvaluator` + pycocotools
(`mask2former/evaluation/instance_evaluation.py` — unused by MAL at
runtime but part of the Mask2Former family): greedy score-ordered matching
per class and IoU threshold, 101-point interpolated average precision,
averaged over the 10 COCO IoU thresholds (0.50:0.05:0.95).

Scope: the "all"-area range with the standard 100-detections-per-image cap
(COCO's small/medium/large area breakdowns are not implemented — the
fine-tuning loop needs the headline AP/AP50/AP75). Host-side numpy by
design: evaluation is offline, ragged, and happens once per epoch — the
hot path stays on the device, this does not.
"""

from __future__ import annotations

import numpy as np

IOU_THRESHOLDS = tuple(np.arange(0.5, 1.0, 0.05).round(2))
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


def mask_iou(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """Pairwise IoU of binary masks. pred (P, H, W), gt (G, H, W) ->
    (P, G)."""
    p = pred.reshape(pred.shape[0], -1).astype(bool)
    g = gt.reshape(gt.shape[0], -1).astype(bool)
    inter = p.astype(np.float64) @ g.T.astype(np.float64)
    union = (p.sum(1)[:, None] + g.sum(1)[None, :]) - inter
    return np.where(union > 0, inter / np.maximum(union, 1), 0.0)


def _match_image(ious: np.ndarray, order: np.ndarray, thr: float
                 ) -> np.ndarray:
    """Greedy COCO matching for one image/class at one threshold.

    ious (P, G) for same-class pred/gt; `order`: pred indices in score-desc
    order. Returns tp (P,) bool in the ORIGINAL pred order: each pred, taken
    best-score-first, claims the unmatched gt with the highest IoU >= thr.
    """
    P, G = ious.shape
    tp = np.zeros(P, bool)
    taken = np.zeros(G, bool)
    for i in order:
        best, best_j = thr, -1
        for j in range(G):
            if not taken[j] and ious[i, j] >= best:
                best, best_j = ious[i, j], j
        if best_j >= 0:
            taken[best_j] = True
            tp[i] = True
    return tp


def _average_precision(tp: np.ndarray, scores: np.ndarray,
                       n_gt: int) -> float:
    """COCO 101-point interpolated AP from per-detection TP flags."""
    if n_gt == 0:
        return float("nan")
    if tp.size == 0:
        return 0.0
    order = np.argsort(-scores, kind="stable")
    tp = tp[order]
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(~tp)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1)
    # monotone-decreasing precision envelope, then sample at 101 recalls
    for i in range(precision.size - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    idx = np.searchsorted(recall, RECALL_POINTS, side="left")
    p_at = np.where(idx < precision.size, precision[np.minimum(
        idx, precision.size - 1)], 0.0)
    return float(p_at.mean())


def evaluate_instances(predictions: list[dict], ground_truths: list[dict],
                       iou_thresholds=IOU_THRESHOLDS,
                       max_dets: int = 100) -> dict[str, float]:
    """Mask AP over a dataset.

    predictions[i]: {"masks" (P,H,W) {0,1}, "scores" (P,), "classes" (P,)}
    ground_truths[i]: {"masks" (G,H,W) {0,1}, "classes" (G,)}
    Returns {"AP", "AP50", "AP75"} (percent, like pycocotools' summarize).
    """
    assert len(predictions) == len(ground_truths)
    classes = sorted({int(c) for g in ground_truths
                      for c in np.asarray(g["classes"]).ravel()})

    # cap detections per image by score (COCO maxDets)
    capped = []
    for p in predictions:
        scores = np.asarray(p["scores"], np.float64)
        keep = np.argsort(-scores, kind="stable")[:max_dets]
        capped.append({"masks": np.asarray(p["masks"])[keep],
                       "scores": scores[keep],
                       "classes": np.asarray(p["classes"]).ravel()[keep]})

    ap_per_thr: dict[float, list[float]] = {t: [] for t in iou_thresholds}
    for cls in classes:
        per_image = []
        n_gt = 0
        for p, g in zip(capped, ground_truths):
            psel = p["classes"] == cls
            gsel = np.asarray(g["classes"]).ravel() == cls
            pm = p["masks"][psel]
            gm = np.asarray(g["masks"])[gsel]
            n_gt += int(gsel.sum())
            ious = mask_iou(pm, gm) if pm.size and gm.size else \
                np.zeros((pm.shape[0], gm.shape[0]))
            per_image.append((ious, p["scores"][psel]))
        for thr in iou_thresholds:
            tps, scs = [], []
            for ious, scores in per_image:
                order = np.argsort(-scores, kind="stable")
                tps.append(_match_image(ious, order, thr))
                scs.append(scores)
            ap = _average_precision(np.concatenate(tps) if tps else
                                    np.zeros(0, bool),
                                    np.concatenate(scs) if scs else
                                    np.zeros(0),
                                    n_gt)
            if not np.isnan(ap):
                ap_per_thr[thr].append(ap)

    def mean_ap(ts):
        vals = [v for t in ts for v in ap_per_thr.get(t, [])]
        return 100.0 * float(np.mean(vals)) if vals else float("nan")

    return {"AP": mean_ap(iou_thresholds),
            "AP50": mean_ap([0.5]),
            "AP75": mean_ap([0.75])}
