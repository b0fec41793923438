"""Visual-inertial BA of the PyTorch port (plain kernel versions on the
CPU) against the JAX package: the inertial edge residual and its
forward-mode (9, 30) Jacobian (within 1e-4 of JAX's jacfwd, finite at the
truth), `vi_ba_solve` on test_vi_ba.py's problems (R, p, v, X within 1e-4,
bias within 1e-5, costs within 1e-3 relative), `classify_outliers`, the
body-tangent K4 blocks against `_visual_terms`' segment sums, and
`optimize_pose_inertial` (K12's plain version: R, t within 1e-5, v, bias
within 1e-4, the same inliers)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rot

from morb_slam_tpu import imu as j_imu
from morb_slam_tpu.optim import vi_ba as j_vi_ba
from morb_slam_tpu_torch import convert
from morb_slam_tpu_torch.optim import ba, vi_ba

from test_vi_ba import CALIB as J_CALIB, DT, make_problem, simulate

torch.set_num_threads(1)


def _port(prob):
    return convert.imu_from_numpy(
        "VIBAProblem", {k: np.asarray(v) for k, v in prob._asdict().items()})


def _t(x):
    return torch.from_numpy(np.array(np.asarray(x), np.float32))


@pytest.mark.parametrize("perturbed", [False, True])
def test_edge_terms_match_jacfwd(perturbed):
    prob, gt = make_problem(W=6, noise_pose=0.03 if perturbed else 0.0,
                            noise_v=0.1 if perturbed else 0.0, seed=4,
                            bias_init=np.array([0.002, -0.001, 0.003, 0.02,
                                                0.01, -0.02]) if perturbed
                            else None)
    if not perturbed:
        f32 = jnp.float32
        prob = prob._replace(R_wb=jnp.asarray(gt["R"], f32),
                             p_wb=jnp.asarray(gt["p"], f32),
                             v=jnp.asarray(gt["v"], f32))
    tp = _port(prob)
    jr, jJ = j_vi_ba._edge_terms(prob, prob.R_wb, prob.p_wb, prob.v,
                                 prob.bias)
    r, J = vi_ba._edge_terms(tp, tp.R_wb, tp.p_wb, tp.v, tp.bias)
    assert torch.isfinite(r).all() and torch.isfinite(J).all()
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-4)
    np.testing.assert_allclose(J.numpy(), np.asarray(jJ), atol=1e-4)
    if not perturbed:
        assert float(r.abs().max()) < 2e-3


@pytest.mark.parametrize("case", ["perturbed", "bias", "landmarks"])
def test_vi_ba_solve_matches_reference(case):
    if case == "perturbed":
        prob, gt = make_problem(W=8, noise_pose=0.03, noise_v=0.15, seed=1)
        n_iters = 6
    elif case == "bias":
        prob, gt = make_problem(W=8, noise_pose=0.0, noise_v=0.05,
                                bg=np.array([0.01, -0.008, 0.006]),
                                ba=np.array([0.05, -0.04, 0.06]), seed=2)
        n_iters = 6
    else:
        prob, gt = make_problem(W=8, noise_pose=0.01, noise_v=0.1, seed=3)
        rng = np.random.default_rng(9)
        Xn = gt["X"] + rng.normal(0, 0.05, gt["X"].shape).astype(np.float32)
        prob = prob._replace(X=jnp.asarray(Xn),
                             lm_opt=jnp.ones(Xn.shape[0], bool))
        n_iters = 6
    jo = j_vi_ba.vi_ba_solve(prob, n_iters=n_iters)
    to = vi_ba.vi_ba_solve(_port(prob), n_iters=n_iters)
    for name, a, b, tol in zip(("R", "p", "v", "bias", "X"), to[:5], jo[:5],
                               (1e-4, 1e-4, 1e-4, 1e-5, 1e-4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol,
                                   err_msg=name)
    # costs within 1e-3 relative; near convergence a float32 sum over the
    # observations carries ~1e-6 of the initial cost as rounding
    np.testing.assert_allclose(to[5]["costs"].numpy(),
                               np.asarray(jo[5]["costs"]), rtol=1e-3,
                               atol=1e-5 * float(jo[5]["cost0"]))
    np.testing.assert_allclose(float(to[5]["cost0"]),
                               float(jo[5]["cost0"]), rtol=1e-3)


def test_classify_outliers_matches_reference():
    prob, gt = make_problem(W=5, noise_pose=0.01, seed=5, px_noise=2.0)
    jk = j_vi_ba.classify_outliers(prob, prob.R_wb, prob.p_wb, prob.X)
    tp = _port(prob)
    tk = vi_ba.classify_outliers(tp, tp.R_wb, tp.p_wb, tp.X)
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert 0 < int(tk.sum()) < int(tp.obs_mask.sum())


def test_body_tangent_blocks_match_visual_terms():
    """K4's plain version in body-tangent mode against the segment sums of
    the reference's `_visual_terms` (the visual blocks of `_lm_step`)."""
    prob, gt = make_problem(W=5, noise_pose=0.02, seed=6, px_noise=1.0)
    prob = prob._replace(lm_opt=jnp.arange(prob.X.shape[0]) % 3 != 0)
    W, L = prob.R_wb.shape[0], prob.X.shape[0]
    r, Jp, Jl, w, _ = j_vi_ba._visual_terms(prob, prob.R_wb, prob.p_wb,
                                            prob.X, robust=True)
    seg = jax.ops.segment_sum
    Hpp = seg(jnp.einsum('oia,o,oib->oab', Jp, w, Jp), prob.obs_kf,
              num_segments=W)
    bp = -seg(jnp.einsum('oia,o,oi->oa', Jp, w, r), prob.obs_kf,
              num_segments=W)
    Hll = seg(jnp.einsum('oia,o,oib->oab', Jl, w, Jl), prob.obs_lm,
              num_segments=L)
    bl = -seg(jnp.einsum('oia,o,oi->oa', Jl, w, r), prob.obs_lm,
              num_segments=L)
    Wpl = jnp.einsum('oia,o,oib->oab', Jp, w, Jl) * \
        (prob.obs_mask * prob.lm_opt[prob.obs_lm])[:, None, None]
    B = jnp.zeros((L, W, 6, 3)).at[prob.obs_lm, prob.obs_kf].add(Wpl)
    tp = _port(prob)
    bap = vi_ba._ba_problem(tp)
    bs = ba.assemble_plain(bap, bap.R, bap.t, tp.X, body=True)
    for name, a, b in (("Hpp", bs.Hpp, Hpp), ("bp", bs.bp, bp),
                       ("Hll", bs.Hll, Hll), ("bl", bs.bl, bl),
                       ("Bt", bs.Bt, B)):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=1e-5,
                                   err_msg=name)
    c = float(jnp.sum(w * jnp.sum(r * r, axis=-1)))
    np.testing.assert_allclose(float(bs.cost), c, rtol=1e-4)


def _pose_inertial_case(stereo: bool, seed: int):
    ts, p, v, R, acc, gyr = simulate(T=0.5)
    k_a, k_c = 40, 50
    pre = j_imu.preintegrate(jnp.asarray(acc[k_a:k_c]),
                             jnp.asarray(gyr[k_a:k_c]),
                             jnp.full(k_c - k_a, DT),
                             jnp.ones(k_c - k_a, bool),
                             jnp.zeros(6, jnp.float32), J_CALIB)
    rng = np.random.default_rng(seed)
    n = 300
    X = rng.uniform([-3, -3, 2.5], [3, 3, 9], (n, 3)).astype(np.float32)
    R_cw_gt = R[k_c].T
    t_cw_gt = -R_cw_gt @ p[k_c]
    Xc = X @ R_cw_gt.T + t_cw_gt
    focal, b = 400.0, 0.11
    obs = (Xc[:, :2] / Xc[:, 2:3] + rng.normal(0, 1.0 / focal, (n, 2))
           ).astype(np.float32)
    obs[:15] += 0.05                                  # outliers
    ur = ((Xc[:, 0] - b) / Xc[:, 2]).astype(np.float32)
    ur = np.where(np.arange(n) % 2 == 0, ur, np.nan).astype(np.float32) \
        if stereo else np.full(n, np.nan, np.float32)
    valid = Xc[:, 2] > 0.5
    dR = Rot.from_rotvec([0.02, -0.015, 0.01]).as_matrix()
    info9 = j_vi_ba.floor_info(0.5 * (jnp.linalg.inv(
        pre.C[:9, :9] + 1e-9 * jnp.eye(9)) + jnp.linalg.inv(
        pre.C[:9, :9] + 1e-9 * jnp.eye(9)).T))
    rw = 1.0 / jnp.clip(jnp.diagonal(pre.C[9:, 9:]), 1e-12, None)
    args = [(dR @ R_cw_gt).astype(np.float32),
            (t_cw_gt + np.array([0.03, -0.02, 0.04])).astype(np.float32),
            (v[k_c] + 0.2).astype(np.float32),
            np.array([0.001, -0.002, 0.001, 0.01, 0.0, -0.01], np.float32),
            X, obs, np.full(n, focal ** 2, np.float32), valid, ur,
            np.float32(b if stereo else 0.0),
            R[k_a].astype(np.float32), p[k_a].astype(np.float32),
            v[k_a].astype(np.float32), np.zeros(6, np.float32),
            pre.dt, pre.dR, pre.dV, pre.dP, pre.J_Rg, pre.J_Vg, pre.J_Va,
            pre.J_Pg, pre.J_Pa, info9, np.zeros(6, np.float32), rw]
    return [np.asarray(a) for a in args]


@pytest.mark.parametrize("stereo", [False, True])
def test_optimize_pose_inertial_matches_reference(stereo):
    args = _pose_inertial_case(stereo, seed=4)
    jo = j_vi_ba.optimize_pose_inertial(*[jnp.asarray(a) for a in args],
                                        n_iters=6)
    targs = [torch.from_numpy(np.array(a)) if a.dtype == np.bool_
             else _t(a) for a in args]
    to = vi_ba.optimize_pose_inertial(*targs, n_iters=6)
    np.testing.assert_allclose(to.R_cw.numpy(), np.asarray(jo.R_cw),
                               atol=1e-5)
    np.testing.assert_allclose(to.t_cw.numpy(), np.asarray(jo.t_cw),
                               atol=1e-5)
    np.testing.assert_allclose(to.v.numpy(), np.asarray(jo.v), atol=1e-4)
    np.testing.assert_allclose(to.bias.numpy(), np.asarray(jo.bias),
                               atol=1e-4)
    assert np.array_equal(to.inliers.numpy(), np.asarray(jo.inliers))
    assert int(to.n_inliers) == int(jo.n_inliers) > 200
    H = np.asarray(jo.H_marg)
    np.testing.assert_allclose(to.H_marg.numpy() / np.abs(H).max(),
                               H / np.abs(H).max(), atol=1e-4)
