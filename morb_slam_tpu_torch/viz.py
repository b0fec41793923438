"""Headless map and trajectory dumps (counterpart of
`morb_slam_tpu/viz.py`): a machine with a card and no display writes files
any workstation opens.

  * `write_ply`     -- landmarks, keyframe centres and frustum edges as an
                       ASCII PLY (MeshLab, CloudCompare);
  * `write_svg`     -- a top-down (x-z) SVG of landmarks, keyframes and the
                       frame trajectory;
  * `frame_overlay` -- a keypoint raster (uint8 RGB) of one frame.

Maps and keypoints may be tensors on the CPU or the card; each function
copies what it draws to the host once.
"""
from __future__ import annotations

import numpy as np
import torch


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _map_arrays(m):
    lm = _host(m.lm_pos)[_host(m.lm_valid)]
    kf_valid = _host(m.kf_valid)
    kf_R = _host(m.kf_R)[kf_valid]
    kf_t = _host(m.kf_t)[kf_valid]
    centers = -np.einsum('kij,ki->kj', kf_R.transpose(0, 2, 1), kf_t)
    return lm, kf_R, kf_t, centers


def write_ply(path: str, m, frustum_scale: float = 0.1):
    """Map dump as ASCII PLY: landmarks (white), keyframe centers (green)
    and frustum edges (reference MapDrawer::DrawMapPoints/DrawKeyFrames)."""
    lm, kf_R, kf_t, centers = _map_arrays(m)
    verts = [(p, (200, 200, 200)) for p in lm]
    edges = []
    s = frustum_scale
    corners_c = np.array([[-s, -s, s * 1.6], [s, -s, s * 1.6],
                          [s, s, s * 1.6], [-s, s, s * 1.6]])
    for R, t, c in zip(kf_R, kf_t, centers):
        base = len(verts)
        verts.append((c, (0, 255, 0)))
        Rwc = R.T
        for cc in corners_c:
            verts.append((Rwc @ (cc - t), (0, 180, 0)))
        for i in range(4):
            edges.append((base, base + 1 + i))
            edges.append((base + 1 + i, base + 1 + (i + 1) % 4))
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\n")
        f.write(f"element edge {len(edges)}\n")
        f.write("property int vertex1\nproperty int vertex2\nend_header\n")
        for p, (r, g, b) in verts:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {r} {g} {b}\n")
        for a, b_ in edges:
            f.write(f"{a} {b_}\n")


def write_svg(path: str, m, trajectory_xyz=None, width: int = 900):
    """Top-down x-z scatter of the map + trajectory polyline as SVG."""
    lm, _, _, centers = _map_arrays(m)
    pts = [lm[:, [0, 2]]] if len(lm) else []
    if len(centers):
        pts.append(centers[:, [0, 2]])
    traj = None
    if trajectory_xyz is not None and len(trajectory_xyz):
        traj = np.asarray(trajectory_xyz)[:, [0, 2]]
        pts.append(traj)
    if not pts:
        with open(path, "w") as f:
            f.write("<svg xmlns='http://www.w3.org/2000/svg'/>")
        return
    allp = np.concatenate(pts)
    lo = allp.min(0) - 0.5
    hi = allp.max(0) + 0.5
    span = np.maximum(hi - lo, 1e-6)
    h = int(width * span[1] / span[0])

    def sx(v):
        return (v - lo[0]) / span[0] * width

    def sy(v):
        return h - (v - lo[1]) / span[1] * h

    out = [f"<svg xmlns='http://www.w3.org/2000/svg' width='{width}' "
           f"height='{h}' style='background:#111'>"]
    for p in lm[:, [0, 2]] if len(lm) else []:
        out.append(f"<circle cx='{sx(p[0]):.1f}' cy='{sy(p[1]):.1f}' "
                   "r='1' fill='#999'/>")
    for c in centers[:, [0, 2]] if len(centers) else []:
        out.append(f"<rect x='{sx(c[0])-2:.1f}' y='{sy(c[1])-2:.1f}' "
                   "width='4' height='4' fill='#4c4'/>")
    if traj is not None:
        d = " ".join(f"{sx(p[0]):.1f},{sy(p[1]):.1f}" for p in traj)
        out.append(f"<polyline points='{d}' fill='none' stroke='#38f' "
                   "stroke-width='1.5'/>")
    out.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(out))


def frame_overlay(img, uv, valid, matched=None):
    """Keypoint overlay raster (reference FrameDrawer::DrawFrame): gray
    image to RGB uint8, green boxes on matched keypoints, blue on
    unmatched. Pure numpy — callers save it however they like."""
    img = _host(img)
    rgb = np.stack([img, img, img], axis=-1).astype(np.uint8)
    uv = _host(uv).astype(int)
    valid = _host(valid)
    matched = (_host(matched) if matched is not None
               else np.zeros(len(uv), bool))
    h, w = img.shape
    for (x, y), ok, mt in zip(uv, valid, matched):
        if not ok or not (2 <= x < w - 2 and 2 <= y < h - 2):
            continue
        color = (0, 255, 0) if mt else (80, 120, 255)
        rgb[y - 2:y + 3, x - 2, :] = color
        rgb[y - 2:y + 3, x + 2, :] = color
        rgb[y - 2, x - 2:x + 3, :] = color
        rgb[y + 2, x - 2:x + 3, :] = color
    return rgb
