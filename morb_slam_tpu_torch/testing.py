"""Helpers that hold a kernel against its plain version: the rows where
two runs of the two-camera match may rightly differ, the term
magnitudes that scale K17's rounding, and the packing of separately
computed pyramid levels into the one buffer K2's `orb_describe_levels`
takes, a synthetic IMU-initialization problem for K17, and the
tolerances that hold K14's solve against its plain version. Used by
`chip_smoke.py`, `tools_kernel_phases.py` and the tests; no pipeline path
calls them.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops import hamming, stereo
from .optim import inertial

# K14's solve (`optim/ba.py:pcg_solve`) against `pcg_solve_plain` on the
# same inputs: dxp and dxl within this share of the plain result's max-abs.
# After 40 CG iterations summed in other orders: the plain solve with its
# dot products in float64 and its observations permuted moved them by up to
# 4.3e-4 on the tests' problems on the CPU.
PCG_TOL = 5e-3
# ... and after 0, 1 and 2 iterations, before CG has converged: float32
# against float64 and a permutation of the observations moved the plain
# solve by up to 1.2e-4 on the tests' problems and at the loop path's
# capacities on the CPU; a fault in alpha, beta or one keyframe's
# preconditioner moved it by 2.2e-2 or more at 2 iterations.
PCG_TOL_FIRST = 1e-3


def general_margins(feats_l, feats_r, bear_l, bear_r, uv_l, uv_r, cam_l,
                    cam_r, R_rl, t_rl, sigma2, idx_a, idx_b, tol=1e-5):
    """Rows where two runs of the two-camera match may rightly differ: a
    pair that could be matched (octaves within 1, both valid, Hamming
    distance within TH_ORB) lies within `tol` of the epipolar gate in the
    row or in the column either run matched it to, or the row's chi2 lies
    within `tol` of its gate for either run's match. Returns (NL,) bool."""
    ep = stereo.epipolar_residual(bear_l, bear_r, R_rl, t_rl)
    oct_ok = torch.abs(feats_l.octave[:, None] - feats_r.octave[None, :]) <= 1
    near = (torch.abs(ep - stereo.EP_GATE) < tol) & oct_ok & \
        feats_l.valid[:, None] & feats_r.valid[None, :] & \
        (hamming.hamming_matrix(feats_l.desc, feats_r.desc) <= stereo.TH_ORB)
    row, col = near.any(dim=1), near.any(dim=0)
    out = row.clone()
    for idx in (idx_a, idx_b):
        j = torch.clamp(idx, min=0).long()
        _, _, e_l, e_r = stereo._triangulate_gate(
            bear_l, bear_r[j], uv_l, uv_r[j], R_rl, t_rl, sigma2, cam_l,
            cam_r, 5.991, 0.9998)
        margin = torch.minimum(torch.abs(e_l - 5.991), torch.abs(e_r - 5.991))
        out |= (idx >= 0) & (col[j] | (margin < tol))
    return out


def inertial_system_magnitudes(p: inertial.InitProblem, x):
    """`inertial.inertial_system_plain`'s sums over the absolute values of
    their terms: (H, g, cost) magnitudes, the scale of each entry's
    rounding."""
    r, J, W = inertial._edge_terms(p, x)
    return inertial._assemble(p, r.abs(), J.abs(), W.abs(), x.abs())


def plain_pyramid_blur(img, n_levels: int, scale: float):
    """The plain K6 (pyramid, then the blur of each level) in the layout
    the one-launch K6 returns: a stand-in for `image.pyramid_blur` that
    forces the plain K6 into `frontend.extract_orb`."""
    from .ops import image
    levels = image.build_pyramid_plain(img, n_levels, scale)
    return pack_levels(levels), pack_levels(
        [image.gaussian_blur_plain(l) for l in levels])


def pack_levels(levels):
    """The images `levels` copied into consecutive contiguous views of one
    buffer, the layout K6 returns and `orb_descriptor.orb_describe_levels`
    takes (for a plain K6 forced into `frontend.extract_orb`)."""
    buf = torch.cat([l.reshape(-1) for l in levels])
    parts = torch.split(buf, [l.numel() for l in levels])
    return [v.view(l.shape) for v, l in zip(parts, levels)]


def init_store(dev, K=256, n_kf=13, seed=0, slots=None):
    """An IMU-initialization problem like the rig's first stage: n_kf
    keyframes 0.25 s apart on a wiggly accelerating path (bias, noise),
    preintegrated by the plain K11 into a K-slot store; the visual poses
    rotated off gravity and scaled by 1 / 2.5. `slots[k]` is the slot of
    the chain's k-th keyframe (default k; a recycled slot holds a later
    keyframe than the slots after it). Returns (ki, R_wb, p_wb,
    kf_valid)."""
    from scipy.spatial.transform import Rotation as Rot
    from . import imu as imu_mod
    rng = np.random.default_rng(seed)
    dt, every = 0.005, 50
    ts = np.arange((n_kf - 1) * every + 1) * dt
    p = np.stack([0.8 * np.sin(1.3 * ts), 0.5 * np.sin(0.9 * ts + 1.0),
                  0.3 * np.sin(1.7 * ts)], -1)
    a = np.stack([-0.8 * 1.3 ** 2 * np.sin(1.3 * ts),
                  -0.5 * 0.9 ** 2 * np.sin(0.9 * ts + 1.0),
                  -0.3 * 1.7 ** 2 * np.sin(1.7 * ts)], -1)
    w_b = np.array([0.3, -0.2, 0.25])
    R = np.stack([Rot.from_rotvec(w_b * t).as_matrix() for t in ts])
    acc = np.einsum('nji,nj->ni', R, a - [0, 0, -9.81]) + [0.03, -0.02, 0.04]
    gyr = np.tile(w_b, (len(ts), 1)) + [0.004, -0.003, 0.002]
    acc = 0.5 * (acc[:-1] + acc[1:]) + rng.normal(0, 0.02, (len(ts) - 1, 3))
    gyr = 0.5 * (gyr[:-1] + gyr[1:]) + rng.normal(0, 0.002, (len(ts) - 1, 3))
    calib = imu_mod.make_calib(np.eye(3), np.zeros(3), 1.7e-4, 2e-3, 1.9e-5,
                               3e-3, 200.0)
    f = lambda v: torch.tensor(np.asarray(v), dtype=torch.float32)
    slots = list(range(n_kf)) if slots is None else list(slots)
    ki = inertial.empty_kf_imu(K)
    for k in range(1, n_kf):
        sl = slice((k - 1) * every, k * every)
        pre = imu_mod.preintegrate_plain(
            f(acc[sl]), f(gyr[sl]), torch.full((every,), dt),
            torch.ones(every, dtype=torch.bool), torch.zeros(6), calib)
        ki = inertial.set_kf_imu(ki, slots[k], pre, slots[k - 1])
    idx = np.arange(n_kf) * every
    R_vg = Rot.from_rotvec([0.25, -0.15, 0.1]).as_matrix()
    R_wb = np.tile(np.eye(3), (K, 1, 1))
    p_wb = np.zeros((K, 3))
    R_wb[slots] = np.einsum('ij,njk->nik', R_vg, R[idx])
    p_wb[slots] = (p[idx] @ R_vg.T) / 2.5
    kf_valid = torch.zeros(K, dtype=torch.bool)
    kf_valid[slots] = True
    ki = inertial.KfImu(*(t.to(dev) for t in ki))
    return ki, f(R_wb).to(dev), f(p_wb).to(dev), kf_valid.to(dev)
