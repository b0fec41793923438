"""IMU preintegration on the manifold with bias Jacobians and the full
covariance (counterpart of `morb_slam_tpu/imu.py`).

`preintegrate` is kernel K11: on CUDA tensors it launches
`csrc/preintegrate.cu`, which runs the whole sample recursion of one call in
one block and leaves the result on the card as one packed tensor that the
returned `Preintegrated` views; on CPU tensors it runs
`preintegrate_plain`, a loop over the valid samples.

Conventions: world gravity (0, 0, -9.81); bias vectors pack [bg(3), ba(3)].
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
from torch.profiler import record_function

from . import lie
from .ops import cuda_build

GRAVITY_VALUE = 9.81

LAUNCHES = {"kernel": 0, "plain": 0}

# packed layout of a Preintegrated (float32 offsets)
_FIELDS = (("dt", ()), ("dR", (3, 3)), ("dV", (3,)), ("dP", (3,)),
           ("C", (15, 15)), ("J_Rg", (3, 3)), ("J_Vg", (3, 3)),
           ("J_Va", (3, 3)), ("J_Pg", (3, 3)), ("J_Pa", (3, 3)),
           ("avg_a", (3,)), ("avg_w", (3,)), ("bias", (6,)))
PACK = sum(math.prod(s) for _, s in _FIELDS)


def gravity(like):
    """(0, 0, -9.81) on `like`'s device, built on the device (an indexed
    assignment of a host scalar would copy it over and sync)."""
    g = torch.full((1,), -GRAVITY_VALUE, dtype=like.dtype, device=like.device)
    return torch.nn.functional.pad(g, (2, 0))


class ImuCalib(NamedTuple):
    """IMU calibration: R_bc (3, 3), t_bc (3,) camera-to-body; cov (6,)
    discrete noise variances [gyro, acc]; cov_walk (6,) random-walk
    variances."""
    R_bc: torch.Tensor
    t_bc: torch.Tensor
    cov: torch.Tensor
    cov_walk: torch.Tensor

    def to(self, device):
        return ImuCalib(*(x.to(device) for x in self))


def make_calib(R_bc, t_bc, noise_gyro, noise_acc, walk_gyro, walk_acc,
               freq: float, device="cpu") -> ImuCalib:
    sf = math.sqrt(freq)
    ng, na = (noise_gyro * sf) ** 2, (noise_acc * sf) ** 2
    wg, wa = (walk_gyro / sf) ** 2, (walk_acc / sf) ** 2

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    return ImuCalib(R_bc=f32(R_bc), t_bc=f32(t_bc),
                    cov=f32([ng] * 3 + [na] * 3),
                    cov_walk=f32([wg] * 3 + [wa] * 3))


class Preintegrated(NamedTuple):
    """Preintegrated IMU deltas between two frames / keyframes: dt ();
    dR (3, 3); dV, dP (3,); C (15, 15) covariance of [dR, dV, dP, bg walk,
    ba walk]; J_Rg, J_Vg, J_Va, J_Pg, J_Pa (3, 3) bias Jacobians; avg_a,
    avg_w (3,) mean measurements; bias (6,) used during integration."""
    dt: torch.Tensor
    dR: torch.Tensor
    dV: torch.Tensor
    dP: torch.Tensor
    C: torch.Tensor
    J_Rg: torch.Tensor
    J_Vg: torch.Tensor
    J_Va: torch.Tensor
    J_Pg: torch.Tensor
    J_Pa: torch.Tensor
    avg_a: torch.Tensor
    avg_w: torch.Tensor
    bias: torch.Tensor


def pack(p: Preintegrated):
    """The (PACK,) float32 tensor of a Preintegrated (field order of
    `_FIELDS`)."""
    return torch.cat([getattr(p, n).reshape(-1) for n, _ in _FIELDS])


def unpack(buf) -> Preintegrated:
    """Views of a (PACK,) tensor as a Preintegrated."""
    out, o = {}, 0
    for name, shape in _FIELDS:
        n = math.prod(shape)
        out[name] = buf[o:o + n].view(shape)
        o += n
    return Preintegrated(**out)


def _normalize_rotation(R):
    """Gram-Schmidt re-orthonormalization of the columns."""
    c0, c1 = R[..., :, 0], R[..., :, 1]
    r0 = c0 / torch.linalg.norm(c0, dim=-1, keepdim=True)
    r1 = c1 - torch.sum(r0 * c1, dim=-1, keepdim=True) * r0
    r1 = r1 / torch.linalg.norm(r1, dim=-1, keepdim=True)
    r2 = torch.linalg.cross(r0, r1, dim=-1)
    return torch.stack([r0, r1, r2], dim=-1)


def preintegrate_plain(acc, gyro, dts, mask, bias, calib: ImuCalib,
                       init: Preintegrated = None) -> Preintegrated:
    """Integrate the valid samples of a masked batch (acc, gyro (N, 3),
    dts (N,), mask (N,) bool) at integration bias `bias` (6,); `init`
    continues an existing preintegration (same bias), restarting the
    measurement averages' count at 1."""
    LAUNCHES["plain"] += 1
    dev, f32 = acc.device, torch.float32
    acc, gyro, dts = acc.to(f32), gyro.to(f32), dts.to(f32)
    bias = bias.to(f32)
    bg, ba = bias[:3], bias[3:]
    Nga = torch.diag(calib.cov.to(f32))
    walk = calib.cov_walk.to(f32)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye9 = torch.eye(9, dtype=f32, device=dev)
    z33 = torch.zeros((3, 3), dtype=f32, device=dev)
    if init is None:
        dt_tot = torch.zeros((), dtype=f32, device=dev)
        dR, dV, dP = eye3, torch.zeros(3, dtype=f32, device=dev), \
            torch.zeros(3, dtype=f32, device=dev)
        C = torch.zeros((15, 15), dtype=f32, device=dev)
        JRg = JVg = JVa = JPg = JPa = z33
        sum_a = torch.zeros(3, dtype=f32, device=dev)
        sum_w = torch.zeros(3, dtype=f32, device=dev)
        n = 0.0
    else:
        dt_tot, dR, dV, dP, C = init.dt, init.dR, init.dV, init.dP, init.C
        JRg, JVg, JVa, JPg, JPa = (init.J_Rg, init.J_Vg, init.J_Va,
                                   init.J_Pg, init.J_Pa)
        sum_a, sum_w = init.avg_a, init.avg_w
        n = 1.0
    for i in torch.nonzero(mask).flatten().tolist():
        a = acc[i] - ba
        w = gyro[i] - bg
        dt = dts[i]
        dt2 = dt * dt
        W_a = lie.so3_hat(a)
        Ra = lie.matvec(dR, a)
        dP_n = dP + dV * dt + 0.5 * Ra * dt2
        dV_n = dV + Ra * dt
        dRi = lie.so3_exp(w * dt)
        Jr = lie.so3_right_jacobian(w * dt)
        RWa = dR @ W_a
        A = eye9.clone()
        A[0:3, 0:3] = dRi.T
        A[3:6, 0:3] = -RWa * dt
        A[6:9, 0:3] = -0.5 * RWa * dt2
        A[6:9, 3:6] = eye3 * dt
        B = torch.zeros((9, 6), dtype=f32, device=dev)
        B[0:3, 0:3] = Jr * dt
        B[3:6, 3:6] = dR * dt
        B[6:9, 3:6] = 0.5 * dR * dt2
        C9 = A @ C[:9, :9] @ A.T + B @ Nga @ B.T
        C_n = C.clone()
        C_n[:9, :9] = C9
        C_n[9:, 9:] = C[9:, 9:] + torch.diag(walk * dt)
        JPa_n = JPa + JVa * dt - 0.5 * dR * dt2
        JPg_n = JPg + JVg * dt - 0.5 * (RWa @ JRg) * dt2
        JVa_n = JVa - dR * dt
        JVg_n = JVg - (RWa @ JRg) * dt
        JRg_n = dRi.T @ JRg - Jr * dt
        dR = _normalize_rotation(dR @ dRi)
        dt_tot, dV, dP, C = dt_tot + dt, dV_n, dP_n, C_n
        JRg, JVg, JVa, JPg, JPa = JRg_n, JVg_n, JVa_n, JPg_n, JPa_n
        sum_a = sum_a + acc[i]
        sum_w = sum_w + gyro[i]
        n += 1.0
    n = max(n, 1.0)
    return Preintegrated(dt=dt_tot, dR=dR, dV=dV, dP=dP, C=C, J_Rg=JRg,
                         J_Vg=JVg, J_Va=JVa, J_Pg=JPg, J_Pa=JPa,
                         avg_a=sum_a / n, avg_w=sum_w / n, bias=bias.clone())


@record_function("K11 preintegrate")
def preintegrate(acc, gyro, dts, mask, bias, calib: ImuCalib,
                 init: Preintegrated = None) -> Preintegrated:
    """K11: `preintegrate_plain`'s function. CUDA tensors: one launch, the
    result a view of one packed tensor on the card; CPU tensors: the plain
    version."""
    if acc.device.type == "cpu":
        return preintegrate_plain(acc, gyro, dts, mask, bias, calib, init)
    if acc.device.type != "cuda":
        raise ValueError(f"preintegrate: unsupported device {acc.device}")
    n = acc.shape[0]
    f32 = torch.float32
    floats = (acc, gyro, dts, bias, calib.cov, calib.cov_walk)
    if any(x.dtype != f32 or x.device != acc.device for x in floats) or \
            mask.dtype != torch.bool or mask.device != acc.device or \
            acc.shape != (n, 3) or gyro.shape != (n, 3) or \
            dts.shape != (n,) or mask.shape != (n,) or bias.shape != (6,) or \
            calib.cov.shape != (6,) or calib.cov_walk.shape != (6,):
        raise ValueError("preintegrate: needs float32 acc, gyro (N, 3), dts "
                         "(N,), bias (6,), calib cov / cov_walk (6,) and a "
                         "bool mask (N,) on one card")
    init_buf = None
    if init is not None:
        init_buf = pack(init).to(f32).contiguous()
        if init_buf.device != acc.device:
            raise ValueError("preintegrate: init lies on another device")
    acc, gyro, dts, mask, bias = (x.contiguous()
                                  for x in (acc, gyro, dts, mask, bias))
    out = torch.empty(PACK, dtype=f32, device=acc.device)
    rc = _lib().preintegrate(
        acc.data_ptr(), gyro.data_ptr(), dts.data_ptr(), mask.data_ptr(),
        bias.data_ptr(), calib.cov.contiguous().data_ptr(),
        calib.cov_walk.contiguous().data_ptr(),
        None if init_buf is None else init_buf.data_ptr(), n,
        out.data_ptr(), cuda_build.stream_ptr(acc))
    cuda_build.check(rc, "preintegrate")
    LAUNCHES["kernel"] += 1
    return unpack(out)


def _lib():
    lib = cuda_build.library("preintegrate")
    if lib.preintegrate.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.preintegrate.argtypes = [P, P, P, P, P, P, P, P, I, P, P]
        lib.preintegrate.restype = I
    return lib


# ---------------------------------------------------------------------------
# bias-corrected deltas and state prediction
# ---------------------------------------------------------------------------

def delta_rotation(p: Preintegrated, bias):
    dbg = bias[:3] - p.bias[:3]
    return _normalize_rotation(
        lie.matmat(p.dR, lie.so3_exp(lie.matvec(p.J_Rg, dbg))))


def delta_velocity(p: Preintegrated, bias):
    dbg = bias[:3] - p.bias[:3]
    dba = bias[3:] - p.bias[3:]
    return p.dV + lie.matvec(p.J_Vg, dbg) + lie.matvec(p.J_Va, dba)


def delta_position(p: Preintegrated, bias):
    dbg = bias[:3] - p.bias[:3]
    dba = bias[3:] - p.bias[3:]
    return p.dP + lie.matvec(p.J_Pg, dbg) + lie.matvec(p.J_Pa, dba)


def predict_state(R_i, p_i, v_i, bias, pre: Preintegrated):
    """Dead-reckoning from body state i through `pre` to state j."""
    dt = pre.dt
    g = gravity(p_i)
    R_j = lie.matmat(R_i, delta_rotation(pre, bias))
    v_j = v_i + g * dt + lie.matvec(R_i, delta_velocity(pre, bias))
    p_j = p_i + v_i * dt + 0.5 * g * dt * dt + \
        lie.matvec(R_i, delta_position(pre, bias))
    return R_j, p_j, v_j
