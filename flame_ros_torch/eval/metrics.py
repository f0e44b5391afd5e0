"""Ground-truth evaluation: confusion matrix + stats.txt protocol.

Counterpart of the device half of `flame_ros_tpu/eval/metrics.py`
(reference: getDepthConfusionMatrix src/utils.cc:326-368, getTruthStats +
stats.txt column schema src/flame_offline_tum.cc:320-398):

- detection = strictly positive GT depth; estimate valid = non-NaN idepth;
- true_pos: both valid -> error |xi_est - 1/depth_gt| accumulates;
- false_pos: estimate without GT -> error |xi_est| accumulates;
- false_neg: GT without estimate; true_neg: neither.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

STATS_COLUMNS = (
    "idx", "timestamp", "runtime", "num_vtx", "num_tris",
    "true_pos", "true_neg", "false_pos", "false_neg",
    "total_idepth_error", "avg_idepth_error", "precision", "recall",
    "total_photo_error", "avg_photo_error",
)


def has_ground_truth(depth) -> bool:
    """Whether a GT depth map (array or tensor) holds any valid depth."""
    if isinstance(depth, torch.Tensor):
        return bool((depth > 0).any())
    return bool(np.any(np.asarray(depth) > 0))


def _nan_to_num(x, nan=0.0):
    return torch.nan_to_num(x, nan=nan)


def depth_confusion_matrix(idepths, depth):
    """Confusion matrix (reference getDepthConfusionMatrix).

    idepths [H, W] estimated inverse depth, NaN where invalid; depth
    [H, W] GT depth in meters, <= 0 where invalid."""
    has_gt = depth > 0
    has_est = torch.isfinite(idepths)
    zero = torch.zeros_like(depth)
    idepth_true = torch.where(has_gt, 1.0 / torch.clamp(depth, min=1e-9),
                              zero)
    tp = has_gt & has_est
    fn = has_gt & ~has_est
    fp = ~has_gt & has_est
    tn = ~has_gt & ~has_est
    err_tp = torch.abs(_nan_to_num(idepths) - idepth_true)
    err_fp = torch.abs(_nan_to_num(idepths))
    err = torch.where(tp, err_tp,
                      torch.where(fp, err_fp, torch.full_like(err_tp,
                                                              float("nan"))))
    total = torch.sum(torch.where(tp | fp, _nan_to_num(err), zero))

    def count(m):
        return torch.sum(m.to(torch.int32))

    return {"idepth_error": err, "total_error": total,
            "true_pos": count(tp), "true_neg": count(tn),
            "false_pos": count(fp), "false_neg": count(fn)}


def idepth_rmse(idepths, depth):
    """Inverse-depth RMSE over pixels with both GT and estimate."""
    has = (depth > 0) & torch.isfinite(idepths)
    zero = torch.zeros_like(depth)
    idepth_true = torch.where(depth > 0, 1.0 / torch.clamp(depth, min=1e-9),
                              zero)
    se = torch.where(has, (_nan_to_num(idepths) - idepth_true) ** 2, zero)
    n = torch.clamp(torch.sum(has.to(torch.float32)), min=1.0)
    return torch.sqrt(torch.sum(se) / n)


def depth_metrics(idepths, depth):
    """Monodepth accuracy metrics over covered GT pixels, in meters:
    abs_rel and the delta inlier ratios (1.25^k, k = 1, 2, 3)."""
    has = (depth > 0) & torch.isfinite(idepths) & (idepths > 1e-6)
    d_est = 1.0 / torch.clamp(_nan_to_num(idepths, nan=1.0), min=1e-6)
    d_gt = torch.clamp(depth, min=1e-6)
    n = torch.clamp(torch.sum(has.to(torch.float32)), min=1.0)
    zero = torch.zeros_like(depth)
    abs_rel = torch.sum(torch.where(has, torch.abs(d_est - d_gt) / d_gt,
                                    zero)) / n
    ratio = torch.maximum(d_est / d_gt, d_gt / d_est)
    out = {"abs_rel": abs_rel}
    for k, thr in ((1, 1.25), (2, 1.25 ** 2), (3, 1.25 ** 3)):
        out[f"delta{k}"] = torch.sum(
            torch.where(has, (ratio < thr).to(torch.float32), zero)) / n
    return out


@dataclass
class TruthStats:
    true_pos: int
    true_neg: int
    false_pos: int
    false_neg: int
    total_error: float
    avg_error: float
    precision: float
    recall: float
    rmse: float
    idepth_error: np.ndarray = None

    @staticmethod
    def from_record(rec: dict) -> "TruthStats":
        """Build from the engine's packed stats (the GT block of
        DEVICE_STATS_KEYS)."""
        tp = int(rec["true_pos"])
        fp = int(rec["false_pos"])
        fn = int(rec["false_neg"])
        total = float(rec["total_idepth_error"])
        return TruthStats(
            true_pos=tp, true_neg=int(rec["true_neg"]), false_pos=fp,
            false_neg=fn, total_error=total,
            avg_error=total / (tp + fp) if tp + fp else float("nan"),
            precision=tp / (tp + fp) if tp + fp else float("nan"),
            recall=tp / (tp + fn) if tp + fn else float("nan"),
            rmse=float(rec["idepth_rmse"]))


class StatsFileWriter:
    """Appends the reference's stats.txt rows (exact column schema,
    src/flame_offline_tum.cc:360-396)."""

    def __init__(self, output_dir: str, fname: str = "stats.txt"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, fname)
        self._wrote_header = os.path.exists(self.path) and \
            os.path.getsize(self.path) > 0

    def append(self, idx: int, timestamp: float, runtime_ms: float,
               num_vtx: int, num_tris: int, ts: TruthStats,
               total_photo_error: float, avg_photo_error: float):
        with open(self.path, "a") as f:
            if not self._wrote_header:
                f.write(" ".join(STATS_COLUMNS) + "\n")
                self._wrote_header = True
            f.write(f"{idx} {timestamp:.6f} {runtime_ms:.6f} "
                    f"{num_vtx} {num_tris} "
                    f"{ts.true_pos} {ts.true_neg} {ts.false_pos} "
                    f"{ts.false_neg} "
                    f"{ts.total_error:.6f} {ts.avg_error:.6f} "
                    f"{ts.precision:.6f} {ts.recall:.6f} "
                    f"{total_photo_error:.6f} {avg_photo_error:.6f}\n")
