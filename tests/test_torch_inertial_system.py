"""The IMU-initialization system of the PyTorch port (K17's plain version,
`inertial.inertial_system_plain`) against the one the JAX package's
`inertial_only_optimize` builds inside its Gauss-Newton step with
`jax.jacfwd` over all 9 + 3K parameters (morb_slam_tpu/optim/inertial.py
:334-379, written out here because it is a closure there), on
test_inertial.py's problem (13 keyframes 0.25 s apart, biased IMU, the
visual poses rotated off gravity and scaled by 1 / 2.5) laid into a
32-slot store with invalid slots, at two points, with the scale
free and fixed: H, g and the cost within 1e-4 of each entry's term
magnitude (the same sums over absolute values, from the port). Then the
whole `inertial_only_optimize` on that store in both packages at the
tracker's settings (25 iterations, accelerometer prior 1e6): R_wg and s
within 1e-4 relative, biases and velocities within 1e-3 of their size, as
test_torch_inertial.py holds them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rot

from morb_slam_tpu import lie as j_lie
from morb_slam_tpu.optim import inertial as j_in
from morb_slam_tpu_torch import convert, testing
from morb_slam_tpu_torch.optim import inertial

from test_inertial import build_kf_imu, simulate_rich

torch.set_num_threads(1)


def _np(x):
    return {k: np.asarray(v) for k, v in x._asdict().items()}


def _pad(d, K):
    """A numpy KfImu dict laid into K slots (the rest invalid)."""
    n = d["valid"].shape[0]
    empty = {k: np.array(v) for k, v in _np(j_in.empty_kf_imu(K)).items()}
    for k, v in d.items():
        empty[k][:n] = v
    return empty


@pytest.fixture(scope="module")
def problem():
    K = 32
    ts, p, v, R, acc, gyr = simulate_rich(
        T=3.0, bg=np.array([0.004, -0.003, 0.002]),
        ba=np.array([0.03, -0.02, 0.04]))
    ki, n_kf = build_kf_imu(ts, acc, gyr)
    d = _pad(_np(ki), K)
    idx = np.arange(n_kf) * 50
    R_vg = Rot.from_rotvec([0.25, -0.15, 0.1]).as_matrix()
    R_wb = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    p_wb = np.zeros((K, 3), np.float32)
    R_wb[:n_kf] = np.einsum('ij,njk->nik', R_vg, R[idx])
    p_wb[:n_kf] = (p[idx] @ R_vg.T) / 2.5
    valid = np.arange(K) < n_kf
    return dict(K=K, d=d, j_ki=j_in.KfImu(**{k: jnp.asarray(v)
                                              for k, v in d.items()}),
                ki=convert.imu_from_numpy("KfImu", d), R_wb=R_wb,
                p_wb=p_wb, valid=valid)


def jax_system(P, x, opt_scale, prior_gyro, prior_acc, base):
    """H, g and the cost of JAX's gn_step / cost_of at x."""
    ki, K = P["j_ki"], P["K"]
    R_wb, p_wb = jnp.asarray(P["R_wb"]), jnp.asarray(P["p_wb"])
    kf_valid = jnp.asarray(P["valid"])
    f32 = jnp.float32
    g0 = jnp.asarray([0.0, 0.0, -j_in.G], f32)

    def residuals(x):
        phi = jnp.concatenate([x[:2], jnp.zeros(1, f32)])
        R_wg = j_lie.matmat(j_lie.so3_exp(phi), base)
        s = jnp.exp(x[2]) if opt_scale else jnp.asarray(1.0, f32)
        return j_in.inertial_residuals(ki, R_wb, p_wb, x[9:].reshape(K, 3),
                                       x[3:6], x[6:9],
                                       j_lie.matvec(R_wg, g0), s)
    w_kf = (ki.valid & kf_valid
            & kf_valid[jnp.clip(ki.prev, 0, None)]).astype(f32)
    floor = jnp.diag(jnp.asarray([9e-6] * 3 + [1e-4] * 3 + [2.5e-5] * 3,
                                 f32))
    info = jnp.linalg.inv(jnp.linalg.inv(ki.info) + floor[None])
    info = 0.5 * (info + jnp.swapaxes(info, -1, -2))
    r = residuals(x)
    J = jax.jacfwd(residuals)(x)
    JtW = jnp.einsum('kap,kab->kbp', J, info,
                     precision='highest') * w_kf[:, None, None]
    H = jnp.einsum('kbp,kbq->pq', JtW, J, precision='highest')
    g = jnp.einsum('kbp,kb->p', JtW, r, precision='highest')
    H = H.at[3:6, 3:6].add(prior_gyro * jnp.eye(3, dtype=f32))
    H = H.at[6:9, 6:9].add(prior_acc * jnp.eye(3, dtype=f32))
    g = g.at[3:6].add(prior_gyro * x[3:6]).at[6:9].add(prior_acc * x[6:9])
    quad = jnp.einsum('ki,kij,kj->k', r, info, r, precision='highest')
    cost = jnp.sum(quad * w_kf) + prior_gyro * jnp.sum(x[3:6] ** 2) + \
        prior_acc * jnp.sum(x[6:9] ** 2)
    return np.asarray(H), np.asarray(g), float(cost)


@pytest.mark.parametrize("opt_scale", [True, False])
@pytest.mark.parametrize("point", [0, 2])
def test_inertial_system_plain_matches_reference(problem, opt_scale, point):
    P, K = problem, problem["K"]
    rng = np.random.default_rng(point)
    base = Rot.from_rotvec([0.25, -0.15, 0.1]).as_matrix().astype(np.float32)
    x = np.zeros(9 + 3 * K, np.float32)
    if point:
        x = rng.normal(0, 0.05 * point, 9 + 3 * K).astype(np.float32)
        x[2] = np.log(2.0 + 0.3 * point)
    pg, pa = 1e2, 1e5
    Hj, gj, cj = jax_system(P, jnp.asarray(x), opt_scale, pg, pa,
                            jnp.asarray(base))
    p = inertial.init_problem(P["ki"], torch.from_numpy(P["R_wb"]),
                              torch.from_numpy(P["p_wb"]),
                              torch.from_numpy(P["valid"]), opt_scale, pg,
                              pa, torch.from_numpy(base))
    H, g, c = inertial.inertial_system_plain(p, torch.from_numpy(x))
    Ha, ga, ca = testing.inertial_system_magnitudes(p, torch.from_numpy(x))
    assert H.shape == (9 + 3 * K, 9 + 3 * K)
    err_H = np.abs(H.numpy() - Hj) / np.maximum(Ha.numpy(), 1e-30)
    err_g = np.abs(g.numpy() - gj) / np.maximum(ga.numpy(), 1e-30)
    assert err_H.max() <= 1e-4, err_H.max()
    assert err_g.max() <= 1e-4, err_g.max()
    assert abs(float(c) - cj) <= 1e-4 * float(ca), (float(c), cj)


@pytest.mark.parametrize("opt_scale", [True, False])
def test_edge_jacobian_equals_func_jvp_bitwise(problem, opt_scale):
    """`_edge_terms`' residuals and Jacobian (`dual.jvp`) bit for bit and
    dtype for dtype against the form they replaced: one `torch.func.jvp`
    of `_edge_residuals` along each of the 15 local columns."""
    P, K = problem, problem["K"]
    x = np.random.default_rng(5).normal(0, 0.1, 9 + 3 * K).astype(
        np.float32)
    x[2] = np.log(2.2)
    base = Rot.from_rotvec([0.25, -0.15, 0.1]).as_matrix().astype(np.float32)
    p = inertial.init_problem(P["ki"], torch.from_numpy(P["R_wb"]),
                              torch.from_numpy(P["p_wb"]),
                              torch.from_numpy(P["valid"]), opt_scale, 1e2,
                              1e5, torch.from_numpy(base))
    x = torch.from_numpy(x)
    r, J, _ = inertial._edge_terms(p, x)
    prev = torch.clamp(p.ki.prev, min=0).long()
    v = x[9:].reshape(K, 3)
    XL = torch.cat([x[:9].expand(K, 9), v[prev], v], dim=1)
    eye = torch.eye(15, dtype=torch.float32)

    def f(xl):
        return inertial._edge_residuals(p, xl)
    J0 = torch.stack([torch.func.jvp(f, (XL,), (eye[d].expand(K, 15),))[1]
                      for d in range(15)], dim=-1).to(torch.float32)
    r0 = f(XL)
    assert r.dtype == r0.dtype and J.dtype == J0.dtype
    assert torch.equal(r, r0)
    assert torch.equal(J, J0)


def test_inertial_only_optimize_matches_reference(problem):
    P = problem
    valid = P["valid"]
    jl = j_in.linear_alignment(P["j_ki"], jnp.asarray(P["R_wb"]),
                               jnp.asarray(P["p_wb"]), jnp.asarray(valid))
    kw = dict(n_iters=25, opt_scale=True, prior_gyro=1e2, prior_acc=1e6,
              s0=float(jl[0]))
    jo = j_in.inertial_only_optimize(
        P["j_ki"], jnp.asarray(P["R_wb"]), jnp.asarray(P["p_wb"]),
        jnp.asarray(valid), v0=jl[2], R_wg0=j_in.gravity_rotation(jl[1]),
        **kw)
    to = inertial.inertial_only_optimize(
        P["ki"], torch.from_numpy(P["R_wb"]), torch.from_numpy(P["p_wb"]),
        torch.from_numpy(valid), v0=torch.from_numpy(np.asarray(jl[2])),
        R_wg0=torch.from_numpy(np.asarray(j_in.gravity_rotation(jl[1]))),
        **kw)
    for name, a, b in zip(("R_wg", "s", "bg", "ba", "v"), to[:5], jo[:5]):
        b = np.asarray(b)
        rtol = 1e-3 if name in ("bg", "ba", "v") else 1e-4
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol,
                                   atol=rtol * max(float(np.abs(b).max()),
                                                   1e-6), err_msg=name)
