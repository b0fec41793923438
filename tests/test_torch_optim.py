"""Parity of the PyTorch port's optimizers with the JAX package:
motion-only `optimize_pose` (R, t within 1e-4, identical inlier masks),
`ba_solve` on test_optim's window problem (R, t, X within 1e-3 relative and
the same accept / reject sequence) and `classify_outliers` (identical)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morb_slam_tpu import lie as j_lie
from morb_slam_tpu.optim import ba as j_ba
from morb_slam_tpu.optim import pose_opt as j_po
from morb_slam_tpu_torch.optim import ba as t_ba
from morb_slam_tpu_torch.optim import pose_opt as t_po

from test_optim import FOCAL, INFO, build_problem, make_world, project_all

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pose_case(seed, n_out, stereo):
    rng = np.random.default_rng(seed)
    X, R, t = make_world(rng, n_kfs=1)
    uv = np.array(project_all(R, t, X, rng, noise_px=0.5)[0])
    uv[:n_out] += rng.uniform(-0.1, 0.1, (n_out, 2)) + 0.02
    dR, dt = j_lie.se3_exp(jnp.asarray([0.1, -0.05, 0.08, 0.02, -0.03, 0.01],
                                       jnp.float32))
    R0, t0 = j_lie.se3_mul(dR, dt, R[0], t[0])
    n = X.shape[0]
    info = np.full(n, INFO, np.float32) * (1.2 ** -(2.0 * rng.integers(0, 4, n)))
    valid = rng.random(n) < 0.95
    ur = None
    if stereo:
        Xc = np.asarray(j_lie.se3_apply(R[0], t[0], X))
        ur = ((Xc[:, 0] - 0.11) / Xc[:, 2]).astype(np.float32)
        ur[rng.random(n) < 0.5] = np.nan
    return (np.asarray(R0), np.asarray(t0), np.asarray(X),
            uv.astype(np.float32), info.astype(np.float32), valid, ur)


@pytest.mark.parametrize("seed,n_out,stereo,rounds,iters", [
    (20, 0, False, 4, 10), (21, 60, False, 4, 10), (22, 30, True, 4, 10),
    (23, 40, False, 2, 8), (24, 80, False, 3, 10), (25, 50, True, 3, 10)])
def test_optimize_pose_parity(seed, n_out, stereo, rounds, iters):
    R0, t0, X, uv, info, valid, ur = _pose_case(seed, n_out, stereo)
    kw = dict(n_rounds=rounds, n_iters=iters)
    if stereo:
        kw.update(baseline=0.11)
    j = j_po.optimize_pose(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(X),
                           jnp.asarray(uv), jnp.asarray(info),
                           jnp.asarray(valid),
                           obs_ur=None if ur is None else jnp.asarray(ur), **kw)
    t = t_po.optimize_pose(_t(R0), _t(t0), _t(X), _t(uv), _t(info), _t(valid),
                           obs_ur=None if ur is None else _t(ur), **kw)
    np.testing.assert_allclose(t.R.numpy(), np.asarray(j.R), atol=1e-4)
    np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), atol=1e-4)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert int(t.n_inliers) == int(j.n_inliers)


def _to_torch_problem(p):
    return t_ba.BAProblem(*[_t(np.asarray(v)) for v in p])


def _rel_close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
    assert err.max() <= tol, err.max()


@pytest.mark.parametrize("seed,mask_frac,rot,outliers", [
    (30, 0.0, 0.0, 0.0), (31, 0.1, 0.0, 0.0), (32, 0.0, 0.15, 0.0),
    (34, 0.0, 0.05, 0.2)])
def test_ba_solve_parity(seed, mask_frac, rot, outliers):
    """2-px observation noise keeps every accept / reject decision far from
    a tie (a converged 0.5-px problem changes its cost in the 7th digit,
    where the two frameworks' summation orders decide)."""
    rng = np.random.default_rng(seed)
    prob, _ = build_problem(rng, noise_px=2.0)
    K = prob.R.shape[0]
    if rot:
        dxi = np.concatenate([np.zeros((2, 6)), rng.normal(0, rot, (K - 2, 6))])
        dR, dt = j_lie.se3_exp(jnp.asarray(dxi, jnp.float32))
        R0, t0 = j_lie.se3_mul(dR, dt, prob.R, prob.t)
        prob = prob._replace(R=R0, t=t0)
    uv = np.array(prob.obs_uv)
    bad = rng.random(len(uv)) < outliers
    uv[bad] += rng.normal(0, 0.1, (int(bad.sum()), 2))
    m = np.array(prob.obs_mask)
    m[rng.random(m.shape) < mask_frac] = False
    prob = prob._replace(obs_uv=jnp.asarray(uv, jnp.float32),
                         obs_mask=jnp.asarray(m))
    Rj, tj, Xj, ij = j_ba.ba_solve(prob, n_iters=6)
    Rt, tt, Xt, it = t_ba.ba_solve(_to_torch_problem(prob), n_iters=6)
    costs = np.concatenate([[float(ij["cost0"])], np.asarray(ij["costs"])])
    np.testing.assert_array_equal(it["accepted"].numpy(),
                                  costs[1:] < costs[:-1])
    _rel_close(Rt.numpy(), Rj, 1e-3)
    _rel_close(tt.numpy(), tj, 1e-3)
    _rel_close(Xt.numpy(), Xj, 1e-3)
    _rel_close(it["costs"].numpy(), np.asarray(ij["costs"]), 1e-3)


@pytest.mark.parametrize("seed", [33, 35])
def test_classify_outliers_parity(seed):
    rng = np.random.default_rng(seed)
    prob, _ = build_problem(rng, perturb=False)
    bad = np.array(prob.obs_uv)
    bad[:50] += 20.0 / FOCAL
    bad[50:80] += rng.normal(0, 2.5 / FOCAL, (30, 2))
    prob2 = prob._replace(obs_uv=jnp.asarray(bad))
    j = j_ba.classify_outliers(prob2, prob.R, prob.t, prob.X)
    t = t_ba.classify_outliers(_to_torch_problem(prob2), _t(prob.R),
                               _t(prob.t), _t(prob.X))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
