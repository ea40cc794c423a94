"""COCO detection evaluation (bbox mAP) in pure numpy.

The port's own copy of `lwdetr_tpu/data/coco_eval.py`. pycocotools is not
a dependency, so this module implements the COCOeval bbox protocol with the
exact matching and accumulation semantics the reference relies on (its
`datasets/coco_eval.py` wraps pycocotools.COCOeval):

* IoU thresholds 0.50:0.05:0.95, recall thresholds 0:0.01:1 (101-point),
  area ranges all/small/medium/large, maxDets (1, 10, 100);
* greedy per-image-per-category matching in score order, crowd GTs use
  intersection-over-detection-area and can absorb multiple detections;
* detections matched to ignored GTs (crowd or out-of-area) are ignored,
  as are unmatched detections outside the area range;
* AP = mean interpolated precision over recall grid and IoU thresholds,
  averaged over categories present in the ground truth.

The distributed merge (reference coco_eval.py:181-200 pickled all_gather)
becomes a list-extend of per-process result arrays (`CocoEvaluator.merge`);
the port's `evaluate` runs on one process.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)

STAT_NAMES = (
    "AP", "AP50", "AP75", "APs", "APm", "APl",
    "AR1", "AR10", "AR100", "ARs", "ARm", "ARl",
)


def iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xywh boxes; crowd gt uses intersection / dt area."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx0, dy0 = dt[:, 0], dt[:, 1]
    dx1, dy1 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx0, gy0 = gt[:, 0], gt[:, 1]
    gx1, gy1 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.clip(np.minimum(dx1[:, None], gx1[None]) - np.maximum(dx0[:, None], gx0[None]), 0, None)
    ih = np.clip(np.minimum(dy1[:, None], gy1[None]) - np.maximum(dy0[:, None], gy0[None]), 0, None)
    inter = iw * ih
    d_area = (dt[:, 2] * dt[:, 3])[:, None]
    g_area = (gt[:, 2] * gt[:, 3])[None]
    union = np.where(iscrowd[None].astype(bool), d_area, d_area + g_area - inter)
    return inter / np.maximum(union, 1e-10)


def _prep_img(dt_boxes, dt_scores, gt_boxes, gt_crowd, gt_area, max_det):
    """Area-range-independent per-(image, category) precompute: score-sorted
    dts and the dt x gt IoU matrix (computed ONCE, like pycocotools'
    computeIoU; the 4 area ranges reuse it)."""
    d_order = np.argsort(-dt_scores, kind="stable")[:max_det]
    dt_boxes_s = dt_boxes[d_order]
    dt_scores_s = dt_scores[d_order]
    ious = iou_xywh(dt_boxes_s, gt_boxes, gt_crowd)
    dt_area = dt_boxes_s[:, 2] * dt_boxes_s[:, 3]
    return dt_boxes_s, dt_scores_s, dt_area, ious


def _evaluate_img(prep, gt_crowd, gt_area, area_items):
    """Greedy matching for one (image, category) at the largest maxDet,
    batched over ALL area ranges (smaller maxDets slice the result columns,
    the A axis indexes area ranges).

    Per-area semantics mirror pycocotools.cocoeval.COCOeval.evaluateImg;
    batching the A=4 ranges into one (A*T, G) sweep amortizes the per-call
    numpy overhead that dominated the per-(img, cat, area) formulation.
    """
    dt_boxes_s, dt_scores_s, dt_area, ious_raw = prep
    T = len(IOU_THRS)
    A = len(area_items)
    D, G = len(dt_scores_s), len(gt_crowd)
    crowd_b = gt_crowd.astype(bool)

    # per-area gt ignore (crowd or out of range) + non-ignored-first sort
    rngs = np.asarray([arng for _, arng in area_items])  # (A, 2)
    gt_ig0 = (crowd_b[None] | (gt_area[None] < rngs[:, :1])
              | (gt_area[None] > rngs[:, 1:]))           # (A, G)
    if G:
        orders = np.argsort(gt_ig0, axis=1, kind="stable")  # (A, G)
        gt_ig = np.take_along_axis(gt_ig0, orders, axis=1)
        crowd_s = crowd_b[orders]
        ious = ious_raw[None][
            np.zeros((A, 1, 1), np.intp),
            np.arange(D)[None, :, None],
            orders[:, None, :]]                          # (A, D, G)
    else:
        gt_ig = gt_ig0
        crowd_s = np.zeros((A, 0), bool)
        ious = np.zeros((A, D, 0))

    dt_m = -np.ones((A, T, D), np.int64)  # matched gt index, -1 unmatched
    gt_m = -np.ones((A, T, G), np.int64)
    if D and G:
        # Greedy matching vectorized over (area x T IoU thresholds).
        # Semantics (pycocotools evaluateImg): scan gts sorted
        # non-ignored-first; a dt takes the max-IoU available gt with
        # iou >= thr, LAST index winning ties (the scalar loop's
        # `< best: continue` update rule); an ignored gt never displaces a
        # non-ignored candidate (the scan breaks at the ignore boundary);
        # matched non-crowd gts become unavailable, crowd gts can absorb
        # any number of dts.
        thr = np.minimum(IOU_THRS, 1 - 1e-10)[None, :, None]  # (1, T, 1)
        crowd3 = crowd_s[:, None, :]                          # (A, 1, G)
        nonig3 = ~gt_ig[:, None, :]
        ig3 = gt_ig[:, None, :]
        any_ig = bool(gt_ig.any())
        gt_m_flat = gt_m.reshape(A * T, G)
        dt_m_flat = dt_m.reshape(A * T, D)
        at_idx = np.arange(A * T)

        def _pick_last_max(cand, iou_d):
            """(A, T, G) candidate mask -> (has, m), each (A, T)."""
            masked = np.where(cand, iou_d[:, None, :], -np.inf)
            best = masked.max(axis=2)
            has = best > -np.inf
            m = (G - 1) - np.argmax(masked[:, :, ::-1] == best[:, :, None],
                                    axis=2)
            return has, m

        for d in range(D):
            iou_d = ious[:, d]  # (A, G)
            avail = (gt_m < 0) | crowd3
            ok = iou_d[:, None, :] >= thr
            has_n, m = _pick_last_max(avail & nonig3 & ok, iou_d)
            if any_ig:
                has_i, m_i = _pick_last_max(avail & ig3 & ok, iou_d)
                m = np.where(has_n, m, np.where(has_i, m_i, -1))
            else:
                m = np.where(has_n, m, -1)
            mf = m.reshape(A * T)
            hit = mf >= 0
            dt_m_flat[hit, d] = mf[hit]
            gt_m_flat[at_idx[hit], mf[hit]] = d
    # dt ignore: matched to ignored gt, or unmatched and dt area out of range
    a_out = ((dt_area[None] < rngs[:, :1])
             | (dt_area[None] > rngs[:, 1:]))            # (A, D)
    matched = dt_m >= 0
    if G:
        ig_of_match = np.take_along_axis(
            np.broadcast_to(gt_ig[:, None, :], (A, T, G)),
            np.clip(dt_m, 0, G - 1), axis=2)  # -1 rows masked below
    else:
        ig_of_match = np.zeros(dt_m.shape, bool)
    dt_ig = np.where(matched, ig_of_match, a_out[:, None, :])
    return {
        "dt_scores": dt_scores_s,
        "dt_matched": matched,          # (A, T, D)
        "dt_ignore": dt_ig,             # (A, T, D)
        "n_gt": (~gt_ig).sum(axis=1),   # (A,)
    }


class CocoEvaluator:
    """Accumulates predictions and computes the 12 COCO bbox statistics.

    Usage:
      ev = CocoEvaluator(gt_index)            # CocoIndex or compatible
      ev.update(results)                      # {img_id: {boxes xyxy, scores, labels}}
      ev.merge(other.export()) for other hosts
      stats = ev.summarize()                  # dict of the 12 stats
    """

    def __init__(self, coco_gt, cat_ids: Optional[Sequence[int]] = None):
        self.coco_gt = coco_gt
        self.cat_ids = list(cat_ids) if cat_ids is not None else coco_gt.get_cat_ids()
        self._gts = defaultdict(lambda: ([], [], []))  # (img, cat) -> boxes, crowd, area
        for img_id in coco_gt.get_img_ids():
            for ann in coco_gt.load_anns(img_id):
                b, c, a = self._gts[(img_id, ann["category_id"])]
                b.append(ann["bbox"])
                c.append(ann.get("iscrowd", 0))
                a.append(ann.get("area", ann["bbox"][2] * ann["bbox"][3]))
        self._dts = defaultdict(lambda: ([], []))  # (img, cat) -> boxes, scores
        self._img_ids: set = set()

    def update(self, results: Dict[int, dict]):
        """results: img_id -> dict(boxes (N,4) xyxy absolute, scores (N,), labels (N,))."""
        for img_id, r in results.items():
            self._img_ids.add(int(img_id))
            boxes = np.asarray(r["boxes"], np.float64).reshape(-1, 4)
            xywh = boxes.copy()
            xywh[:, 2:] -= xywh[:, :2]
            scores = np.asarray(r["scores"], np.float64).reshape(-1)
            labels = np.asarray(r["labels"], np.int64).reshape(-1)
            for cat in np.unique(labels):
                sel = labels == cat
                b, s = self._dts[(int(img_id), int(cat))]
                b.extend(xywh[sel].tolist())
                s.extend(scores[sel].tolist())

    def export(self):
        """Per-host state for cross-host merging."""
        return {"img_ids": sorted(self._img_ids),
                "dts": {k: v for k, v in self._dts.items()}}

    def merge(self, exported):
        self._img_ids.update(exported["img_ids"])
        for k, (b, s) in exported["dts"].items():
            mb, ms = self._dts[k]
            mb.extend(b)
            ms.extend(s)

    def summarize(self, verbose: bool = True) -> Dict[str, float]:
        img_ids = sorted(self._img_ids) if self._img_ids else self.coco_gt.get_img_ids()
        T, R = len(IOU_THRS), len(REC_THRS)
        A, M, K = len(AREA_RNG), len(MAX_DETS), len(self.cat_ids)
        area_items = list(AREA_RNG.items())

        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        for ki, cat in enumerate(self.cat_ids):
            # per-(img, cat) precompute shared by all 4 area ranges: sorted
            # dts + the IoU matrix (pycocotools computes IoU once likewise)
            per_img = []
            for img_id in img_ids:
                gb, gc, ga = self._gts.get((img_id, cat), ([], [], []))
                db, ds = self._dts.get((img_id, cat), ([], []))
                if not gb and not db:
                    continue
                gc = np.asarray(gc, np.int64)
                ga = np.asarray(ga, np.float64)
                prep = _prep_img(
                    np.asarray(db, np.float64).reshape(-1, 4),
                    np.asarray(ds, np.float64),
                    np.asarray(gb, np.float64).reshape(-1, 4),
                    gc, ga, MAX_DETS[-1])
                per_img.append((prep, gc, ga))
            if not per_img:
                continue
            # one matching per (img, cat) at maxDets[-1], batched over the 4
            # area ranges; smaller maxDets slice the per-image dt columns
            # (greedy matching is prefix-stable in score order — the match
            # of detection i never depends on lower-scored detections),
            # exactly as pycocotools' accumulate slices evaluateImg results
            evals = [
                _evaluate_img(prep, gc, ga, area_items)
                for (prep, gc, ga) in per_img
            ]
            n_gt_a = np.sum([e["n_gt"] for e in evals], axis=0)  # (A,)
            for ai, (aname, arng) in enumerate(area_items):
                n_gt = int(n_gt_a[ai])
                if n_gt == 0:
                    continue
                for mi, max_det in enumerate(MAX_DETS):
                    scores = np.concatenate(
                        [e["dt_scores"][:max_det] for e in evals])
                    order = np.argsort(-scores, kind="mergesort")
                    matched = np.concatenate(
                        [e["dt_matched"][ai, :, :max_det] for e in evals],
                        axis=1)[:, order]
                    ignored = np.concatenate(
                        [e["dt_ignore"][ai, :, :max_det] for e in evals],
                        axis=1)[:, order]

                    tps = matched & ~ignored
                    fps = ~matched & ~ignored
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    n = tp_sum.shape[1]
                    if n == 0:
                        recall[:, ki, ai, mi] = 0.0
                        precision[:, :, ki, ai, mi] = 0.0
                        continue
                    rc = tp_sum / n_gt                      # (T, n)
                    pr = tp_sum / np.maximum(
                        tp_sum + fp_sum, np.finfo(np.float64).eps)
                    recall[:, ki, ai, mi] = rc[:, -1]
                    # monotone precision envelope (right-to-left running max)
                    env = np.maximum.accumulate(pr[:, ::-1], axis=1)[:, ::-1]
                    # first index with rc >= REC_THRS, per threshold row
                    inds = np.stack([np.searchsorted(rc[ti], REC_THRS, "left")
                                     for ti in range(T)])  # (T, R)
                    valid = inds < n
                    q = np.where(
                        valid,
                        np.take_along_axis(
                            env, np.minimum(inds, n - 1), axis=1),
                        0.0)
                    precision[:, :, ki, ai, mi] = q

        def _ap(ai, mi, ti=None):
            p = precision[:, :, :, ai, mi] if ti is None else precision[ti:ti + 1, :, :, ai, mi]
            p = p[p > -1]
            return float(np.mean(p)) if p.size else -1.0

        def _ar(ai, mi):
            r = recall[:, :, ai, mi]
            r = r[r > -1]
            return float(np.mean(r)) if r.size else -1.0

        # retained for offline analysis dumps (reference main.py:402-411
        # saves coco_eval['bbox'].eval to output_dir/eval/)
        self.eval = {"precision": precision, "recall": recall}
        ai_all = list(AREA_RNG).index("all")
        stats = {
            "AP": _ap(ai_all, 2),
            "AP50": _ap(ai_all, 2, 0),
            "AP75": _ap(ai_all, 2, 5),
            "APs": _ap(list(AREA_RNG).index("small"), 2),
            "APm": _ap(list(AREA_RNG).index("medium"), 2),
            "APl": _ap(list(AREA_RNG).index("large"), 2),
            "AR1": _ar(ai_all, 0),
            "AR10": _ar(ai_all, 1),
            "AR100": _ar(ai_all, 2),
            "ARs": _ar(list(AREA_RNG).index("small"), 2),
            "ARm": _ar(list(AREA_RNG).index("medium"), 2),
            "ARl": _ar(list(AREA_RNG).index("large"), 2),
        }
        if verbose:
            for k, v in stats.items():
                print(f"  {k:6s} = {v:.3f}")
        return stats
