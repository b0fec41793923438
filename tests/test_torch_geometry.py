"""Parity of the PyTorch port's geometry substrate (lie, cameras,
alignment, optim.linalg) with the JAX package: the cases of test_lie.py,
test_cameras.py and test_alignment.py, inputs made with numpy from a seed,
run through both packages, compared within 1e-5 (absolute, or relative for
values far above 1)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScipyRot

from morb_slam_tpu import alignment as j_al
from morb_slam_tpu import cameras as j_cam
from morb_slam_tpu import lie as j_lie
from morb_slam_tpu.optim import linalg as j_linalg
from morb_slam_tpu_torch import alignment as t_al
from morb_slam_tpu_torch import cameras as t_cam
from morb_slam_tpu_torch import lie as t_lie
from morb_slam_tpu_torch.optim import linalg as t_linalg

torch.set_num_threads(1)
TOL = 1e-5


def _close(a, b, tol=TOL):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = np.maximum(1.0, np.abs(b))
    err = np.max(np.abs(a - b) / scale) if a.size else 0.0
    assert err <= tol, err


def _both(fn_j, fn_t, *arrays):
    """Run fn_j on jnp float32 copies and fn_t on torch copies."""
    js = [jnp.asarray(a) for a in arrays]
    ts = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    rj, rt = fn_j(*js), fn_t(*ts)
    if not isinstance(rj, tuple):
        rj, rt = (rj,), (rt,)
    for a, b in zip(rt, rj):
        _close(a.numpy(), b)


def _w(rng, n, scale):
    return (rng.normal(size=(n, 3)) * scale).astype(np.float32)


def _clip_angle(w, max_angle=3.0):
    n = np.linalg.norm(w, axis=-1, keepdims=True)
    return (w * np.minimum(n, max_angle) / n).astype(np.float32)


LIE_CASES = {
    "so3_exp": lambda r: (("so3_exp",), _w(r, 64, 2.0)),
    "so3_log_roundtrip": lambda r: (("so3_log",), np.asarray(ScipyRot.from_rotvec(
        _clip_angle(_w(r, 128, 1.0))).as_matrix(), np.float32)),
    "so3_log_near_pi": lambda r: (("so3_log_rot",), np.asarray(
        (r.normal(size=(32, 3)) / np.linalg.norm(r.normal(size=(32, 3)), axis=-1,
                                                  keepdims=True)) * (np.pi - 1e-4),
        np.float32)),
    "so3_small_angle": lambda r: (("so3_log_rot",), _w(r, 16, 1e-6)),
    "so3_right_jacobian": lambda r: (("so3_right_jacobian",), _w(r, 16, 1.0)),
    "so3_right_jacobian_inv": lambda r: (("so3_right_jacobian_inv",), _w(r, 16, 1.0)),
    "se3_exp": lambda r: (("se3_exp",), (r.normal(size=(32, 6)) * 0.8).astype(np.float32)),
    "se3_log": lambda r: (("se3_log",), (r.normal(size=(32, 6)) * 0.8).astype(np.float32)),
    "sim3_exp": lambda r: (("sim3_exp",), (r.normal(size=(64, 7)) * 0.8).astype(np.float32)),
    "sim3_log": lambda r: (("sim3_log",), (r.normal(size=(64, 7)) * 0.8).astype(np.float32)),
    "sim3_zero_sigma": lambda r: (("sim3_exp",), np.concatenate(
        [r.normal(size=(16, 6)), np.zeros((16, 1))], 1).astype(np.float32)),
    "quat": lambda r: (("quat",), np.asarray(ScipyRot.random(64, rng=r).as_quat(),
                                             np.float32)),
}


def _lie_op(lib, op):
    if op == "so3_log_rot":
        return lambda w: lib.so3_log(lib.so3_exp(w))
    if op == "se3_log":
        return lambda xi: lib.se3_log(*lib.se3_exp(xi))
    if op == "sim3_log":
        return lambda xi: lib.sim3_log(*lib.sim3_exp(xi))
    if op == "quat":
        return lambda q: (lib.quat_to_rotmat(q),
                          lib.rotmat_to_quat(lib.quat_to_rotmat(q)))
    return getattr(lib, op)


@pytest.mark.parametrize("case", sorted(LIE_CASES))
def test_lie_parity(case):
    (op,), x = LIE_CASES[case](np.random.default_rng(0))
    js, ts = jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))
    rj, rt = _lie_op(j_lie, op)(js), _lie_op(t_lie, op)(ts)
    if not isinstance(rj, tuple):
        rj, rt = (rj,), (rt,)
    for a, b in zip(rt, rj):
        _close(a.numpy(), b)


def test_se3_group_ops_parity():
    rng = np.random.default_rng(1)
    xa = (rng.normal(size=(16, 6)) * 0.5).astype(np.float32)
    xb = (rng.normal(size=(16, 6)) * 0.5).astype(np.float32)
    p = rng.normal(size=(16, 3)).astype(np.float32)

    def run(lib, xa, xb, p):
        Ra, ta = lib.se3_exp(xa)
        Rb, tb = lib.se3_exp(xb)
        Rc, tc = lib.se3_mul(Ra, ta, *lib.se3_inv(Rb, tb))
        return Rc, tc, lib.se3_apply(Ra, ta, p), lib.se3_matrix(Ra, ta)
    _both(lambda *a: run(j_lie, *a), lambda *a: run(t_lie, *a), xa, xb, p)


def test_sim3_group_ops_parity():
    rng = np.random.default_rng(2)
    xi = (rng.normal(size=(16, 7)) * 0.5).astype(np.float32)
    p = rng.normal(size=(16, 3)).astype(np.float32)

    def run(lib, xi, p):
        s, R, t = lib.sim3_exp(xi)
        si, Ri, ti = lib.sim3_inv(s, R, t)
        return lib.sim3_mul(s, R, t, si, Ri, ti) + (lib.sim3_apply(s, R, t, p),)
    _both(lambda *a: run(j_lie, *a), lambda *a: run(t_lie, *a), xi, p)


PIN_ARGS = (458.654, 457.296, 367.215, 248.375,
            [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05])
KB8_ARGS = (190.978, 190.973, 254.932, 256.897,
            0.00348238, 0.000715034, -0.00205323, 0.000202936)


def _cams(kind):
    if kind == "pinhole":
        return (j_cam.pinhole(*PIN_ARGS[:4], dist=PIN_ARGS[4]),
                t_cam.pinhole(*PIN_ARGS[:4], dist=PIN_ARGS[4]))
    return j_cam.kannala_brandt8(*KB8_ARGS), t_cam.kannala_brandt8(*KB8_ARGS)


def _cam_points(rng, n, fov_scale):
    d = rng.normal(size=(n, 3)) * np.array([fov_scale, fov_scale, 0.0]) \
        + np.array([0, 0, 1.0])
    d[:, 2] = rng.uniform(0.5, 10.0, size=n)
    d[:, :2] *= d[:, 2:3]
    return d.astype(np.float32)


CAM_OPS = ["project", "project_jac", "unproject_of_project",
           "bearing_of_project", "project_distorted", "undistort_points",
           "K"]


@pytest.mark.parametrize("kind", ["pinhole", "kb8"])
@pytest.mark.parametrize("op", CAM_OPS)
def test_camera_parity(kind, op):
    jc, tc = _cams(kind)
    rng = np.random.default_rng(3)
    p = _cam_points(rng, 256, 0.6 if kind == "pinhole" else 1.0)

    def run(lib, cam, p):
        if op == "K":
            return cam.K()
        if op == "unproject_of_project":
            return lib.unproject(cam, lib.project(cam, p))
        if op == "bearing_of_project":
            return lib.unproject_bearing(cam, lib.project(cam, p))
        if op == "undistort_points":
            return lib.undistort_points(cam, lib.project_distorted(cam, p))
        return getattr(lib, op)(cam, p)
    _both(lambda q: run(j_cam, jc, q), lambda q: run(t_cam, tc, q), p)


ALIGN_CASES = ["sim3", "se3", "weighted", "reflection", "ate_sim3", "ate_se3"]


@pytest.mark.parametrize("case", ALIGN_CASES)
def test_alignment_parity(case):
    """Compares s and the aligned points (the SVD's U and V are sign
    ambiguous), and the ATE."""
    rng = np.random.default_rng(4)
    src = rng.normal(size=(100, 3)).astype(np.float32)
    if case == "reflection":
        src = (src * np.array([1, 1, 1e-4])).astype(np.float32)
    s_gt, R_gt, t_gt = (np.asarray(v) for v in j_lie.sim3_exp(
        jnp.asarray(rng.normal(size=(7,)) * 0.5, jnp.float32)))
    dst = (s_gt * src @ R_gt.T + t_gt + rng.normal(size=src.shape) * 0.01
           ).astype(np.float32)
    w = np.ones(100, np.float32)
    if case == "weighted":
        dst[:5] += 100.0
        w[:5] = 0.0
    with_scale = case in ("sim3", "weighted", "ate_sim3")

    def run(lib, src, dst, w):
        if case.startswith("ate"):
            rmse, s, R, t = lib.ate_rmse(src, dst, with_scale=with_scale)
        else:
            s, R, t = lib.umeyama(src, dst, weights=w, with_scale=with_scale)
            rmse = s * 0
        aligned = s * (src @ R.T) + t
        return rmse, s, aligned
    _both(lambda *a: run(j_al, *a), lambda *a: run(t_al, *a), src, dst, w)


@pytest.mark.parametrize("op", ["inv3x3", "inv6x6", "solve_6x6", "solve_spd"])
def test_linalg_parity(op):
    rng = np.random.default_rng(5)
    n = 3 if op == "inv3x3" else 6
    A = rng.normal(size=(16, n, n))
    A = (A @ np.swapaxes(A, -1, -2) + n * np.eye(n)).astype(np.float32)
    b = rng.normal(size=(16, n)).astype(np.float32)

    def run(lib, A, b):
        if op.startswith("solve"):
            return getattr(lib, op)(A, b)
        return getattr(lib, op)(A)
    _both(lambda *a: run(j_linalg, *a), lambda *a: run(t_linalg, *a), A, b)
