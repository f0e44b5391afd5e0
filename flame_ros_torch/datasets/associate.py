"""Timestamp association between sensor streams.

A copy of `flame_ros_tpu/datasets/associate.py` (host numpy).

Vectorized reimplementation of dataset_utils::associate (reference:
src/dataset_utils/utils.h:50-93): greedily match each item of stream A to
its nearest-in-time item of stream B, dropping pairs farther apart than
max_diff (the reference's EuRoC default is 0.02 s,
asl_rgbd_offline_stream.cc:152-203).
"""
from __future__ import annotations

import numpy as np


def associate(times_a: np.ndarray, times_b: np.ndarray,
              max_diff: float = 0.02) -> tuple[np.ndarray, np.ndarray]:
    """Returns (idx_a, idx_b) index arrays of matched pairs, in time order.

    Each A item maps to the nearest B item; pairs with |dt| > max_diff are
    dropped. A B item may match at most one A item (ties keep the closer
    one, matching the reference's greedy scan).
    """
    ta = np.asarray(times_a, np.float64)
    tb = np.asarray(times_b, np.float64)
    if len(ta) == 0 or len(tb) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order_b = np.argsort(tb, kind="stable")
    tb_sorted = tb[order_b]
    pos = np.searchsorted(tb_sorted, ta)
    left = np.clip(pos - 1, 0, len(tb) - 1)
    right = np.clip(pos, 0, len(tb) - 1)
    pick = np.where(np.abs(tb_sorted[right] - ta)
                    < np.abs(tb_sorted[left] - ta), right, left)
    diff = np.abs(tb_sorted[pick] - ta)
    ok = diff <= max_diff
    idx_a = np.flatnonzero(ok)
    idx_b = order_b[pick[ok]]
    # Enforce one-to-one: keep the closest A for any duplicated B.
    best: dict[int, int] = {}
    for a, b in zip(idx_a, idx_b):
        if b not in best or abs(ta[a] - tb[b]) < abs(ta[best[b]] - tb[b]):
            best[b] = a
    pairs = sorted((a, b) for b, a in best.items())
    if not pairs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ia, ib = zip(*pairs)
    return np.asarray(ia, np.int64), np.asarray(ib, np.int64)
