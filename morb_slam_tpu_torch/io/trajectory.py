"""Trajectory writers and readers in the TUM, EuRoC and KITTI formats
(counterpart of `morb_slam_tpu/io/trajectory.py`).

Poses arrive as (ts, R_cw, t_cw) triples of numpy arrays or tensors, on
the CPU or the card; a writer moves them to the host once for the whole
file and writes camera-to-world poses. The text formats are the reference
package's, digit for digit, so a file written by either package reads the
same in the other.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import lie


def _host_poses(poses):
    """(ts list, R_wc (N, 3, 3), t_wc (N, 3), quat_xyzw (N, 4)) on the host,
    from one device-to-host copy of all the poses."""
    poses = list(poses)
    ts = [float(p[0]) for p in poses]
    if not poses:
        z = np.zeros((0, 3), np.float32)
        return ts, np.zeros((0, 3, 3), np.float32), z, np.zeros((0, 4))
    if torch.is_tensor(poses[0][1]):
        R = torch.stack([p[1] for p in poses]).cpu().numpy()
        t = torch.stack([p[2] for p in poses]).cpu().numpy()
    else:
        R = np.stack([np.asarray(p[1]) for p in poses])
        t = np.stack([np.asarray(p[2]) for p in poses])
    Rwc = np.ascontiguousarray(R.transpose(0, 2, 1))
    twc = np.stack([-Rwc[i] @ t[i] for i in range(len(poses))])
    q = lie.rotmat_to_quat(torch.from_numpy(Rwc.astype(np.float32))).numpy()
    return ts, Rwc, twc, q


def write_tum(path, poses):
    """TUM: `ts tx ty tz qx qy qz qw` per line."""
    ts, _, twc, q = _host_poses(poses)
    with open(path, "w") as f:
        for k, stamp in enumerate(ts):
            p, r = twc[k], q[k]
            f.write(f"{stamp:.6f} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f} "
                    f"{r[0]:.7f} {r[1]:.7f} {r[2]:.7f} {r[3]:.7f}\n")


def write_euroc(path, poses):
    """EuRoC: `ts_ns,tx,ty,tz,qw,qx,qy,qz` under a header line."""
    ts, _, twc, q = _host_poses(poses)
    with open(path, "w") as f:
        f.write("#timestamp [ns], p_x, p_y, p_z, q_w, q_x, q_y, q_z\n")
        for k, stamp in enumerate(ts):
            p, r = twc[k], q[k]
            f.write(f"{int(round(stamp * 1e9))},{p[0]:.7f},{p[1]:.7f},"
                    f"{p[2]:.7f},{r[3]:.7f},{r[0]:.7f},{r[1]:.7f},"
                    f"{r[2]:.7f}\n")


def write_kitti(path, poses):
    """KITTI: the row-major 3x4 T_wc, 12 numbers per line."""
    _, Rwc, twc, _ = _host_poses(poses)
    with open(path, "w") as f:
        for R, t in zip(Rwc, twc):
            M = np.concatenate([R, t[:, None]], axis=1)
            f.write(" ".join(f"{x:.9e}" for x in M.reshape(-1)) + "\n")


def read_tum(path):
    """-> (ts (N,), pos (N, 3), quat_xyzw (N, 4)). Reads EuRoC csv files
    (comma-separated, nanoseconds, qw first) as well."""
    ts, pos, quat = [], [], []
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        sep = "," if "," in line else None
        p = [float(x) for x in line.split(sep)]
        if len(p) < 8:
            continue
        t = p[0]
        if t > 1e14:   # nanoseconds
            t *= 1e-9
        ts.append(t)
        pos.append(p[1:4])
        quat.append([p[5], p[6], p[7], p[4]] if sep else p[4:8])
    return (np.asarray(ts), np.asarray(pos, np.float64),
            np.asarray(quat, np.float64))


def associate(ts_a, ts_b, max_dt: float = 0.02):
    """Greedy nearest-timestamp association within max_dt, each entry of
    ts_b used once. Returns (idx_a, idx_b)."""
    ia, ib = [], []
    used = np.zeros(len(ts_b), bool)
    for i, t in enumerate(ts_a):
        j = int(np.searchsorted(ts_b, t))
        best, best_dt = -1, max_dt
        for jj in (j - 1, j, j + 1):
            if 0 <= jj < len(ts_b) and not used[jj]:
                dt = abs(ts_b[jj] - t)
                if dt < best_dt:
                    best, best_dt = jj, dt
        if best >= 0:
            used[best] = True
            ia.append(i)
            ib.append(best)
    return np.asarray(ia, np.int64), np.asarray(ib, np.int64)
