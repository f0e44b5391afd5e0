"""Coordinate-frame convention normalization.

A copy of `flame_ros_tpu/geometry/frames.py` (host numpy).

All engine-facing poses are camera-to-world in Right-Down-Forward (RDF,
"optical") coordinates, matching the reference's normalization contract
(reference: tum_rgbd_offline_stream.h:72-80 / .cc:146-194 for TUM input
frames, asl_rgbd_offline_stream.h:69-78 / .cc:235-275 for ASL world frames).

Two distinct cases, as in the reference:
- The input pose is expressed *entirely* in another convention (body axes =
  world axes convention): conjugate, q' = C q C^-1, t' = C t.
- The local frame is already RDF but the *global* frame uses another
  convention ("RDF_IN_X"): rotate only the global side, q' = C q, t' = C t.
"""
from __future__ import annotations

import numpy as np

# Quaternions (w, x, y, z) taking vectors in the named convention to RDF.
_Q_FLU_TO_RDF = np.array([-0.5, -0.5, 0.5, -0.5], np.float64)
# FRD -> RDF permutation matrix: rows of R_frd_to_rdf = [[0,1,0],[0,0,1],[1,0,0]]
_Q_FRD_TO_RDF = None  # built lazily from matrix below
_R_FRD_TO_RDF = np.array([[0.0, 1.0, 0.0],
                          [0.0, 0.0, 1.0],
                          [1.0, 0.0, 0.0]])
_R_RFU_TO_RDF = np.array([[1.0, 0.0, 0.0],
                          [0.0, 0.0, -1.0],
                          [0.0, 1.0, 0.0]])

TUM_FRAMES = ("RDF", "FLU", "FRD", "RDF_IN_FLU", "RDF_IN_FRD")
ASL_FRAMES = ("RDF", "FLU", "FRD", "RFU")


def _qmul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def _qconj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _qrot(q, v):
    qv = q[1:]
    uv = 2.0 * np.cross(qv, v)
    return v + q[0] * uv + np.cross(qv, uv)


def _quat_from_matrix(R):
    w = 0.5 * np.sqrt(max(1.0 + R[0, 0] + R[1, 1] + R[2, 2], 1e-12))
    x = (R[2, 1] - R[1, 2]) / (4 * w)
    y = (R[0, 2] - R[2, 0]) / (4 * w)
    z = (R[1, 0] - R[0, 1]) / (4 * w)
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def _frame_quat(name: str):
    if name in ("FLU", "RDF_IN_FLU"):
        return _Q_FLU_TO_RDF
    if name in ("FRD", "RDF_IN_FRD"):
        return _quat_from_matrix(_R_FRD_TO_RDF)
    if name == "RFU":
        return _quat_from_matrix(_R_RFU_TO_RDF)
    raise ValueError(f"Unknown frame convention: {name}")


def to_rdf(quat_wxyz: np.ndarray, trans: np.ndarray,
           input_frame: str) -> tuple[np.ndarray, np.ndarray]:
    """Normalize a pose to RDF optical coordinates.

    quat/trans are a camera(or body)-to-world pose in `input_frame`
    convention; returns (quat, trans) in RDF. Matches the reference switch
    (tum_rgbd_offline_stream.cc:146-194): plain conventions conjugate, the
    RDF_IN_* variants (and ASL's FLU/FRD/RFU world frames, which apply to an
    already-optical camera pose) rotate only the world side.
    """
    q = np.asarray(quat_wxyz, np.float64)
    t = np.asarray(trans, np.float64)
    if input_frame == "RDF":
        return q, t
    c = _frame_quat(input_frame)
    if input_frame in ("FLU", "FRD"):
        q_out = _qmul(_qmul(c, q), _qconj(c))
    else:  # RDF_IN_FLU / RDF_IN_FRD and any one-sided use
        q_out = _qmul(c, q)
    t_out = _qrot(c, t)
    return q_out / np.linalg.norm(q_out), t_out


def world_to_rdf(quat_wxyz: np.ndarray, trans: np.ndarray,
                 world_frame: str) -> tuple[np.ndarray, np.ndarray]:
    """ASL-style normalization: local frame already RDF, world frame differs
    (reference: asl_rgbd_offline_stream.cc:235-275 — always one-sided)."""
    q = np.asarray(quat_wxyz, np.float64)
    t = np.asarray(trans, np.float64)
    if world_frame == "RDF":
        return q, t
    c = _frame_quat(world_frame)
    q_out = _qmul(c, q)
    return q_out / np.linalg.norm(q_out), _qrot(c, t)
