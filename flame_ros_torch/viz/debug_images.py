"""Debug image renderings.

Counterpart of `flame_ros_tpu/viz/debug_images.py`: the same host
drawing, reading the port's engine getters.

Parity with the reference's six debug products (reference:
src/flame_nodelet.cc:769-809, cfg debug/*, README.md:224-226 — wireframe,
features, detections, matches, normals, idepthmap, each behind a config
flag because rendering costs frame time), plus the text overlay and
180-degree flip options. Host-side drawing uses OpenCV like the reference;
dense colormaps come from the device rasterization.
"""
from __future__ import annotations

import numpy as np

from flame_ros_torch.ops.colormap import apply_colormap_over, jet_u8
from flame_ros_torch.ops.epipolar import STATUS_OK


def _to_rgb(gray: np.ndarray) -> np.ndarray:
    g = np.clip(np.asarray(gray), 0, 255).astype(np.uint8)
    return np.stack([g] * 3, -1)


def _maybe_flip(img: np.ndarray, flip: bool) -> np.ndarray:
    return img[::-1, ::-1] if flip else img


def _overlay_text(img: np.ndarray, text: str) -> np.ndarray:
    import cv2
    cv2.putText(img, text, (10, img.shape[0] - 6),
                cv2.FONT_HERSHEY_SIMPLEX, 0.4, (200, 200, 250), 1, 8)
    return img


def draw_wireframe(gray, vtx_uv, vtx_x, tris, tri_keep, *,
                   color_scale: float = 1.0, text: str = "",
                   flip: bool = False) -> np.ndarray:
    """Mesh edges colored by idepth (reference debug/wireframe)."""
    import cv2
    img = _to_rgb(gray)
    uv = np.asarray(vtx_uv)
    x = np.asarray(vtx_x) * color_scale
    for t, keep in zip(np.asarray(tris), np.asarray(tri_keep)):
        if not keep:
            continue
        for a, b in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            c = jet_u8(0.5 * (x[a] + x[b]), 0.0, 1.0).tolist()
            cv2.line(img, tuple(np.round(uv[a]).astype(int)),
                     tuple(np.round(uv[b]).astype(int)), c, 1, cv2.LINE_AA)
    if text:
        _overlay_text(img, text)
    return _maybe_flip(img, flip)


def draw_features(gray, uv, idepths, valid, *, color_scale: float = 1.0,
                  text: str = "", flip: bool = False) -> np.ndarray:
    """Feature points colored by idepth (reference debug/features)."""
    import cv2
    img = _to_rgb(gray)
    uv = np.asarray(uv)
    xs = np.asarray(idepths) * color_scale
    for p, x, ok in zip(uv, xs, np.asarray(valid)):
        if not ok:
            continue
        cv2.circle(img, tuple(np.round(p).astype(int)), 2,
                   jet_u8(x, 0.0, 1.0).tolist(), -1, cv2.LINE_AA)
    if text:
        _overlay_text(img, text)
    return _maybe_flip(img, flip)


def draw_detections(gray, det_uv, det_valid, *, flip: bool = False
                    ) -> np.ndarray:
    """New detections (reference debug/detections)."""
    import cv2
    img = _to_rgb(gray)
    for p, ok in zip(np.asarray(det_uv), np.asarray(det_valid)):
        if not ok:
            continue
        cv2.drawMarker(img, tuple(np.round(p).astype(int)), (0, 255, 255),
                       cv2.MARKER_CROSS, 5)
    return _maybe_flip(img, flip)


def draw_matches(gray, uv_start, uv_match, status, valid, *,
                 flip: bool = False) -> np.ndarray:
    """Epipolar searches: green = success, red = failure (reference
    debug/matches, src/flame_nodelet.cc:786-791)."""
    import cv2
    img = _to_rgb(gray)
    st = np.asarray(status)
    for p0, p1, s, ok in zip(np.asarray(uv_start), np.asarray(uv_match),
                             st, np.asarray(valid)):
        if not ok or s == 0:
            continue
        color = (0, 255, 0) if s == STATUS_OK else (255, 0, 0)
        cv2.line(img, tuple(np.round(p0).astype(int)),
                 tuple(np.round(p1).astype(int)), color, 1, cv2.LINE_AA)
        cv2.circle(img, tuple(np.round(p1).astype(int)), 1, color, -1)
    return _maybe_flip(img, flip)


def draw_idepthmap(gray, idepth_map, *, color_scale: float = 1.0,
                   vmax: float = 1.0, text: str = "",
                   flip: bool = False) -> np.ndarray:
    """Dense colored idepth map over the image (reference debug/idepthmap,
    colored by scene_color_scale * idepth)."""
    img = _to_rgb(gray)
    vals = np.asarray(idepth_map) * color_scale
    img = apply_colormap_over(img, vals, 0.0, vmax)
    if text:
        _overlay_text(img, text)
    return _maybe_flip(img, flip)


def draw_normals(gray, idepth_map, normal_map, *, flip: bool = False
                 ) -> np.ndarray:
    """Normal-vector coloring: n mapped to RGB (reference debug/normals)."""
    img = _to_rgb(gray)
    n = np.asarray(normal_map)
    m = np.isfinite(np.asarray(idepth_map)) & np.isfinite(n).all(-1)
    rgb = (np.nan_to_num(n * 0.5 + 0.5, nan=0.0) * 255).astype(np.uint8)
    img[m] = rgb[m]
    return _maybe_flip(img, flip)


def render_debug_images(engine, gray: np.ndarray) -> dict:
    """All enabled debug images for the engine's current state (driven by
    params.debug flags like the reference's per-topic publishers)."""
    p = engine.params
    d = p.debug
    out = {}
    scale = p.output.scene_color_scale
    txt = ""
    if d.text_overlay:
        s = engine.stats_
        txt = (f"feats:{int(s.stats('num_feats'))} "
               f"tris:{int(s.stats('num_tris'))} "
               f"cov:{s.stats('coverage'):.2f}")
    uv, x, normals, tris, keep, edges = engine.get_inverse_depth_mesh()
    if d.wireframe:
        out["wireframe"] = draw_wireframe(
            gray, uv, x, tris, keep, color_scale=scale, text=txt,
            flip=d.flip_images)
    if d.features:
        vtx, mu, var = engine.get_raw_idepths()
        out["features"] = draw_features(
            gray, vtx, mu, np.ones(len(vtx), bool), color_scale=scale,
            text=txt, flip=d.flip_images)
    if d.idepthmap:
        out["idepthmap"] = draw_idepthmap(
            gray, engine.get_inverse_depth_map(), color_scale=scale,
            text=txt, flip=d.flip_images)
    if d.matches and engine.last_status is not None:
        st = engine.state
        vtx_uv = st.vtx_uv.cpu().numpy()
        uv_match = (engine._dev_uv_match.cpu().numpy()
                    if engine._dev_uv_match is not None else vtx_uv)
        out["matches"] = draw_matches(
            gray, vtx_uv, uv_match, engine.last_status,
            st.feat.valid.cpu().numpy(), flip=d.flip_images)
    if d.detections:
        det = engine.get_detections()
        if det is not None:
            out["detections"] = draw_detections(gray, det[0], det[1],
                                                flip=d.flip_images)
    if d.normals:
        out["normals"] = draw_normals(
            gray, engine.get_inverse_depth_map(), engine.get_normal_map(),
            flip=d.flip_images)
    return out
