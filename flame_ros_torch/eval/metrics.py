"""Ground-truth evaluation: confusion matrix + stats.txt protocol.

Counterpart of the device half of `flame_ros_tpu/eval/metrics.py`
(reference: getDepthConfusionMatrix src/utils.cc:326-368, getTruthStats +
stats.txt column schema src/flame_offline_tum.cc:320-398):

- detection = strictly positive GT depth; estimate valid = non-NaN idepth;
- true_pos: both valid -> error |xi_est - 1/depth_gt| accumulates;
- false_pos: estimate without GT -> error |xi_est| accumulates;
- false_neg: GT without estimate; true_neg: neither.

Trajectory metrics for tracking mode (`align_trajectory`, `ate_rmse`,
`rpe`) are host numpy in float64, copied from the JAX package's, as is
`load_stats_file`; `truth_stats` is the host wrapper of the device
half, run on the CPU.
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


def align_trajectory(est_t: np.ndarray, gt_t: np.ndarray,
                     with_scale: bool = False):
    """Umeyama/Horn closed-form trajectory alignment.

    est_t, gt_t: [N, 3] camera positions. Returns (s, R, t) minimizing
    || gt - (s * R @ est + t) ||^2 over rotations R (and uniform scale s
    when with_scale, else s = 1 — the SE3/Horn variant).
    """
    est = np.asarray(est_t, np.float64)
    gt = np.asarray(gt_t, np.float64)
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    E = est - mu_e
    G = gt - mu_g
    C = G.T @ E / len(est)
    U, S, Vt = np.linalg.svd(C)
    d = np.sign(np.linalg.det(U) * np.linalg.det(Vt))
    D = np.diag([1.0, 1.0, d])
    R = U @ D @ Vt
    if with_scale:
        var_e = (E ** 2).sum() / len(est)
        s = float(np.trace(np.diag(S) @ D) / max(var_e, 1e-12))
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray,
             align: str = "se3") -> float:
    """Absolute trajectory error RMSE, the TUM RGB-D benchmark's
    evaluate_ate protocol: align estimated positions to GT, then RMSE of
    the residuals.

    align: "se3" (Horn rotation+translation — scale errors count, since
    the monocular scale is anchored by the bootstrap depth), "sim3"
    (+uniform scale: drift with scale removed), or "none" (origin-aligned
    raw residuals — both trajectories start at identity).
    """
    est = np.asarray(est_t, np.float64)
    gt = np.asarray(gt_t, np.float64)
    if align == "none":
        res = gt - est
    else:
        s, R, t = align_trajectory(est, gt, with_scale=(align == "sim3"))
        res = gt - (s * (R @ est.T).T + t)
    return float(np.sqrt(np.mean(np.sum(res ** 2, axis=1))))


def _rotmats_from_quats(q: np.ndarray) -> np.ndarray:
    """[N, 4] (w,x,y,z) unit quaternions -> [N, 3, 3] rotation matrices
    (numpy, float64)."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty((len(q), 3, 3))
    R[:, 0, 0] = 1 - 2 * (y * y + z * z)
    R[:, 0, 1] = 2 * (x * y - w * z)
    R[:, 0, 2] = 2 * (x * z + w * y)
    R[:, 1, 0] = 2 * (x * y + w * z)
    R[:, 1, 1] = 1 - 2 * (x * x + z * z)
    R[:, 1, 2] = 2 * (y * z - w * x)
    R[:, 2, 0] = 2 * (x * z - w * y)
    R[:, 2, 1] = 2 * (y * z + w * x)
    R[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def rpe(est_q: np.ndarray, est_t: np.ndarray,
        gt_q: np.ndarray, gt_t: np.ndarray,
        delta: int = 1) -> dict:
    """Relative pose error over frame pairs (i, i+delta), the TUM RGB-D
    benchmark's evaluate_rpe protocol: rotational RPE sees every
    per-frame orientation error, which ATE on a short rotation-dominant
    path does not.

    Per pair: E_i = (P_gt_i^-1 P_gt_{i+d})^-1 (P_est_i^-1 P_est_{i+d});
    translational error = ||trans(E_i)|| (metres), rotational error =
    angle(rot(E_i)) (degrees). Inputs: [N, 4] (w,x,y,z) quats + [N, 3]
    positions, camera-to-world, frame-aligned est/gt. Returns rmse,
    mean, and max for both error families.
    """
    est_q, est_t = np.asarray(est_q), np.asarray(est_t, np.float64)
    gt_q, gt_t = np.asarray(gt_q), np.asarray(gt_t, np.float64)
    n = len(est_t)
    if n != len(gt_t) or n < delta + 1:
        raise ValueError(f"need matched trajectories with > delta={delta} "
                         f"poses, got {n} est / {len(gt_t)} gt")
    Re, Rg = _rotmats_from_quats(est_q), _rotmats_from_quats(gt_q)
    i, j = np.arange(n - delta), np.arange(delta, n)
    # Relative motions P_i^-1 P_j: R_rel = R_i^T R_j, t_rel = R_i^T (t_j - t_i)
    Re_rel = np.einsum("nba,nbc->nac", Re[i], Re[j])
    te_rel = np.einsum("nba,nb->na", Re[i], est_t[j] - est_t[i])
    Rg_rel = np.einsum("nba,nbc->nac", Rg[i], Rg[j])
    tg_rel = np.einsum("nba,nb->na", Rg[i], gt_t[j] - gt_t[i])
    # Error transform E = rel_gt^-1 rel_est
    RE = np.einsum("nba,nbc->nac", Rg_rel, Re_rel)
    tE = np.einsum("nba,nb->na", Rg_rel, te_rel - tg_rel)
    t_err = np.linalg.norm(tE, axis=1)
    cos = np.clip((np.trace(RE, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    r_err = np.degrees(np.arccos(cos))

    def rms(v):
        return float(np.sqrt(np.mean(v ** 2)))

    return {"trans_rmse": rms(t_err), "trans_mean": float(t_err.mean()),
            "trans_max": float(t_err.max()),
            "rot_rmse_deg": rms(r_err), "rot_mean_deg": float(r_err.mean()),
            "rot_max_deg": float(r_err.max()), "delta": int(delta),
            "pairs": int(n - delta)}


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


def truth_stats(idepths, depth) -> TruthStats:
    """Host-facing wrapper (reference getTruthStats computation block):
    the confusion matrix and RMSE of an [H, W] inverse-depth estimate
    (NaN where invalid) against GT depth in meters, numpy or tensors,
    computed on the CPU."""
    idepths = torch.as_tensor(np.asarray(idepths, np.float32))
    depth = torch.as_tensor(np.asarray(depth, np.float32))
    cm = depth_confusion_matrix(idepths, depth)
    tp, tn, fp, fn = (int(cm[k]) for k in ("true_pos", "true_neg",
                                           "false_pos", "false_neg"))
    total = float(cm["total_error"])
    return TruthStats(
        true_pos=tp, true_neg=tn, false_pos=fp, false_neg=fn,
        total_error=total,
        avg_error=total / (tp + fp) if tp + fp else float("nan"),
        precision=tp / (tp + fp) if tp + fp else float("nan"),
        recall=tp / (tp + fn) if tp + fn else float("nan"),
        rmse=float(idepth_rmse(idepths, depth)),
        idepth_error=cm["idepth_error"].numpy())


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


def load_stats_file(path: str) -> dict:
    """Parse a stats.txt (StatsFileWriter) back into column arrays."""
    with open(path) as f:
        header = f.readline().split()
        rows = [[float(x) for x in line.split()] for line in f
                if line.strip()]
    arr = np.asarray(rows)
    return ({c: arr[:, i] for i, c in enumerate(header)} if rows else
            {c: np.zeros(0) for c in header})
