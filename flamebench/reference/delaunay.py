"""Host-side Delaunay triangulation: native C++ engine + scipy fallback.

The benchmark's frozen copy of the port's `flame_ros_torch/graph/delaunay.py`
(same algorithm, same jitter), with its own copy of the native source.

Graph construction (reference: flame::utils::Triangulator, `triangulate`
stage — SURVEY §2.9) runs on the host at poseframe rate; its edge/triangle
lists feed the on-device NLTGV2-L1 smoothing every frame. The native
implementation is an incremental ghost-triangle Bowyer–Watson
(native/delaunay.cpp beside this file) compiled on first use with g++ and
loaded via ctypes; scipy.spatial.Delaunay (Qhull) is the fallback.

Inputs are deterministically jittered by a hash-based sub-milli-pixel
offset before triangulating: detections sit on integer pixel grids, which
produce exactly-cocircular quadruples that non-exact incircle predicates
cannot order consistently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "native")
_SRC = os.path.join(_NATIVE_DIR, "delaunay.cpp")
_SO = os.path.join(_NATIVE_DIR, "build", "libflame_delaunay.so")

_lock = threading.Lock()
_lib = None
_lib_failed = False


def _src_hash() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.blake2b(f.read(), digest_size=16).hexdigest()


def _build_native() -> bool:
    """Compile into a per-process temporary name and rename into place,
    so processes building at the same time never load a partial file."""
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        with open(tmp + ".hash", "w") as f:
            f.write(_src_hash())
        os.replace(tmp + ".hash", _SO + ".srchash")
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _so_current() -> bool:
    """The binary is used only if it was built from the current source
    (verified by content hash, not mtimes — git checkouts do not preserve
    mtime ordering, and an unverifiable stale/foreign blob must never
    load)."""
    if not os.path.exists(_SO):
        return False
    try:
        with open(_SO + ".srchash") as f:
            return f.read().strip() == _src_hash()
    except OSError:
        return False


def _get_lib():
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if not _so_current():
            if not _build_native():
                _lib_failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO)
            lib.delaunay_triangulate.restype = ctypes.c_int
            lib.delaunay_triangulate.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ]
            _lib = lib
        except OSError:
            _lib_failed = True
        return _lib


def _jitter(pts: np.ndarray) -> np.ndarray:
    """Deterministic sub-milli-pixel jitter breaking cocircular grid cases."""
    h = hashlib.blake2b(np.ascontiguousarray(pts).tobytes(),
                        digest_size=8).digest()
    rng = np.random.default_rng(int.from_bytes(h, "little"))
    return pts + rng.uniform(-5e-4, 5e-4, pts.shape)


def _morton_order(pts: np.ndarray) -> np.ndarray:
    """Spatial (Morton/Z-order) insertion order: locality for the walking
    point location, and spatially-coherent triangle ids for the device
    rasterizer's block-bbox culling."""
    q = np.clip((pts - pts.min(0)) / max(np.ptp(pts, 0).max(), 1e-9),
                0, 1)
    xi = (q[:, 0] * 0xFFFF).astype(np.uint64)
    yi = (q[:, 1] * 0xFFFF).astype(np.uint64)

    def spread(v):
        v = (v | (v << 8)) & np.uint64(0x00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x33333333)
        v = (v | (v << 1)) & np.uint64(0x55555555)
        return v

    return np.argsort(spread(xi) | (spread(yi) << np.uint64(1)))


def triangulate(points: np.ndarray) -> np.ndarray:
    """Delaunay-triangulate 2D points. Returns [M, 3] int32 triangle vertex
    indices (CCW, indices into the input array). M == 0 for degenerate
    inputs (< 3 points or all collinear)."""
    pts = np.asarray(points, np.float64)
    if pts.ndim != 2 or pts.shape[1] != 2:
        raise ValueError(f"points must be [N, 2], got {pts.shape}")
    n = len(pts)
    if n < 3:
        return np.zeros((0, 3), np.int32)

    # Exactly-degenerate (collinear) input has no triangulation; check
    # before jitter would manufacture sliver triangles out of it.
    scale = max(np.ptp(pts[:, 0]), np.ptp(pts[:, 1]), 1e-12)
    d = (pts - pts.mean(0)) / scale
    if np.linalg.svd(d, compute_uv=False)[-1] < 1e-9:
        return np.zeros((0, 3), np.int32)

    jpts = _jitter(pts)
    lib = _get_lib()
    if lib is not None:
        order = _morton_order(jpts)
        sorted_pts = np.ascontiguousarray(jpts[order])
        max_tris = 2 * n + 16
        out = np.empty((max_tris, 3), np.int32)
        count = lib.delaunay_triangulate(
            sorted_pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_tris)
        if count >= 0:
            tris = order[out[:count]].astype(np.int32)
            return np.ascontiguousarray(tris)
        # fall through to scipy on native failure

    from scipy.spatial import Delaunay, QhullError
    try:
        tris = Delaunay(jpts).simplices.astype(np.int32)
    except QhullError:
        return np.zeros((0, 3), np.int32)
    # Qhull does not guarantee orientation; normalize to CCW.
    a, b, c = jpts[tris[:, 0]], jpts[tris[:, 1]], jpts[tris[:, 2]]
    cw = ((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
          - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])) < 0
    tris[cw] = tris[cw][:, [0, 2, 1]]
    return tris


def edges_from_triangles(tris: np.ndarray) -> np.ndarray:
    """Unique undirected edges [E, 2] (sorted pairs) of a triangle list."""
    if len(tris) == 0:
        return np.zeros((0, 2), np.int32)
    e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0).astype(np.int32)
