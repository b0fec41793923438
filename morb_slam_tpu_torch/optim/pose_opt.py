"""Motion-only pose optimization: Gauss-Newton on one SE(3) pose with
Huber-weighted reprojection residuals and the reference's optimize-then-
reclassify outlier rounds (counterpart of `morb_slam_tpu/optim/pose_opt.py`).

`optimize_pose` is kernel K5: on CUDA tensors it launches
`csrc/pose_opt.cu`, which runs every round and Gauss-Newton step of one
call in a single launch; on CPU tensors it runs `optimize_pose_plain`.

Pose convention: T_cw, residuals in normalized image coordinates,
information = focal^2 / sigma^2, left-composed updates T <- exp(dx) T.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.profiler import record_function

from .. import lie
from ..ops import cuda_build
from ..tensor_ops import einsum
from . import linalg
from .robust import huber_weight

CHI2_MONO = 5.991
CHI2_STEREO = 7.815

LAUNCHES = {"kernel": 0, "plain": 0}


class PoseOptResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor     # (N,) bool final chi2 classification
    n_inliers: torch.Tensor
    chi2: torch.Tensor


def _jacobian_se3(Xc):
    """d Xc / d dx = [I | -hat(Xc)], (N, 3, 6)."""
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(
        Xc.shape[:-1] + (3, 3))
    return torch.cat([eye, -lie.so3_hat(Xc)], dim=-1)


def optimize_pose_plain(R0, t0, Xw, obs, info, valid, obs_ur=None,
                        baseline=0.0, n_rounds: int = 4, n_iters: int = 10):
    """Motion-only BA over world points Xw (N, 3) observed at normalized
    coords obs (N, 2) with information info (N,). Stereo rows (finite
    obs_ur) add the right-image residual."""
    LAUNCHES["plain"] += 1
    if obs_ur is None:
        obs_ur = torch.full((obs.shape[0],), float("nan"), dtype=obs.dtype,
                            device=obs.device)
    is_stereo = torch.isfinite(obs_ur)
    st_f = is_stereo.to(obs.dtype)
    chi2_th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO).to(obs.dtype)
    ur0 = torch.nan_to_num(obs_ur)
    eye6 = 1e-6 * torch.eye(6, dtype=obs.dtype, device=obs.device)

    def gn_step(R, t, active):
        Xc = lie.se3_apply(R, t, Xw)
        x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
        zs = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        iz = 1.0 / zs
        iz2 = iz * iz
        r2 = Xc[..., :2] / zs[..., None] - obs
        r_ur = torch.where(is_stereo, (x - baseline) / zs - ur0,
                           torch.zeros_like(z))
        zero = torch.zeros_like(z)
        J_pt = torch.stack([torch.stack([iz, zero, -x * iz2], dim=-1),
                            torch.stack([zero, iz, -y * iz2], dim=-1)],
                           dim=-2)                               # (N, 2, 3)
        J_se3 = _jacobian_se3(Xc)
        J2 = torch.einsum('nij,njk->nik', J_pt, J_se3)           # (N, 2, 6)
        Jr_pt = torch.stack([iz, zero, -(x - baseline) * iz2], dim=-1)
        Jr = torch.einsum('nj,njk->nk', Jr_pt, J_se3)            # (N, 6)
        chi2 = (torch.sum(r2 * r2, dim=-1) + r_ur * r_ur) * info
        w = info * huber_weight(chi2, chi2_th) * active
        w = torch.where(z > 0, w, torch.zeros_like(w))
        ws = w * st_f
        H = (einsum('nia,n,nib->ab', J2, w, J2)
             + einsum('na,n,nb->ab', Jr, ws, Jr)) + eye6
        g = (einsum('nia,n,ni->a', J2, w, r2)
             + einsum('na,n,n->a', Jr, ws, r_ur))
        dx = -linalg.solve_6x6(H, g)
        dR, dt = lie.se3_exp(dx)
        return lie.se3_mul(dR, dt, R, t), chi2

    R, t = R0, t0
    active = valid.to(obs.dtype)
    for _ in range(n_rounds):
        for _ in range(n_iters):
            (R, t), _ = gn_step(R, t, active)
        _, chi2 = gn_step(R, t, active)
        active = (valid & (chi2 < chi2_th)).to(obs.dtype)
    _, chi2 = gn_step(R, t, active)
    inl = valid & (chi2 < chi2_th)
    return PoseOptResult(R=R, t=t, inliers=inl, n_inliers=torch.sum(inl),
                         chi2=chi2)


@record_function("K5 optimize_pose")
def optimize_pose(R0, t0, Xw, obs, info, valid, obs_ur=None, baseline=0.0,
                  n_rounds: int = 4, n_iters: int = 10):
    """K5: `optimize_pose_plain`'s function. CUDA tensors: one launch of the
    kernel, results left on the card; CPU tensors: the plain version."""
    if Xw.device.type == "cpu":
        return optimize_pose_plain(R0, t0, Xw, obs, info, valid, obs_ur,
                                   baseline, n_rounds, n_iters)
    if Xw.device.type != "cuda":
        raise ValueError(f"pose_opt: unsupported device {Xw.device}")
    n = Xw.shape[0]
    f32 = torch.float32
    tensors = (R0, t0, Xw, obs, info) + (() if obs_ur is None else (obs_ur,))
    if any(x.dtype != f32 or x.device != Xw.device for x in tensors) or \
            valid.dtype != torch.bool or valid.device != Xw.device or \
            R0.shape != (3, 3) or t0.shape != (3,) or Xw.shape != (n, 3) or \
            obs.shape != (n, 2) or info.shape != (n,) or \
            valid.shape != (n,) or \
            (obs_ur is not None and obs_ur.shape != (n,)) or \
            n_rounds < 0 or n_iters < 0:
        raise ValueError("pose_opt: needs float32 R0 (3, 3), t0 (3,), Xw "
                         "(N, 3), obs (N, 2), info (N,), obs_ur (N,) or None "
                         "and a bool valid (N,) on one card")
    if obs.stride(1) != 1:
        obs = obs.contiguous()
    R0, t0, Xw, info, valid = (x.contiguous()
                               for x in (R0, t0, Xw, info, valid))
    ur = None if obs_ur is None else obs_ur.contiguous()
    dev = Xw.device
    R = torch.empty((3, 3), dtype=f32, device=dev)
    t = torch.empty(3, dtype=f32, device=dev)
    inl = torch.empty(n, dtype=torch.bool, device=dev)
    chi2 = torch.empty(n, dtype=f32, device=dev)
    n_inl = torch.empty((), dtype=torch.int64, device=dev)
    rc = _lib().pose_opt(
        R0.data_ptr(), t0.data_ptr(), Xw.data_ptr(), obs.data_ptr(),
        obs.stride(0), info.data_ptr(), valid.data_ptr(),
        None if ur is None else ur.data_ptr(), float(baseline), n,
        int(n_rounds), int(n_iters), R.data_ptr(), t.data_ptr(),
        inl.data_ptr(), chi2.data_ptr(), n_inl.data_ptr(),
        cuda_build.stream_ptr(Xw))
    cuda_build.check(rc, "pose_opt")
    LAUNCHES["kernel"] += 1
    return PoseOptResult(R=R, t=t, inliers=inl, n_inliers=n_inl, chi2=chi2)


def _lib():
    lib = cuda_build.library("pose_opt")
    if lib.pose_opt.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.pose_opt.argtypes = [P, P, P, P, I, P, P, P, ctypes.c_float, I,
                                 I, I, P, P, P, P, P, P]
        lib.pose_opt.restype = I
    return lib
