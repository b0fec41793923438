"""K13's plain versions (the inertial part of a VI-BA LM step) of the
PyTorch port against the JAX package on the CPU, on test_vi_ba.py's
windows (make_problem) at full_inertial_ba's and local_inertial_ba's sizes,
W = 32 and W = 14, with invalid slots, a fixed pose, bias priors and (at
W = 14) a chain that skips a slot; the W = 32 window is the one the solve
below runs, built once:

- `inertial_system_plain` against the system assembled in numpy (float64)
  from JAX's `_edge_terms` by the reference `_lm_step`'s formulas
  (vi_ba.py:278-321): H within 1e-5 under Jacobi scaling (|dH_ij| /
  sqrt(H_ii H_jj)), b within 1e-5 of its scaled max-abs (|db_i| /
  sqrt(H_ii));
- `inertial_cost_plain` within 1e-4 relative of JAX's `_quad_costs`;
- `vi_ba_solve` at W = 32 at test_torch_vi_ba.py's tolerances (R, p, v, X
  within 1e-4, bias within 1e-5, costs within 1e-3 relative); this case
  sits here, not in that file's `test_vi_ba_solve_matches_reference`,
  to keep each file under ~75 s (the JAX solve compiles for ~25 s).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morb_slam_tpu.optim import vi_ba as j_vi_ba
from morb_slam_tpu_torch.optim import vi_ba

from test_torch_vi_ba import _port
from test_vi_ba import make_problem

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _window_case(W, skip, invalid, seed):
    """make_problem's window at W slots, keyframes 0.1 s apart: the
    `invalid` slots lose their edge, slot `skip` is chained to skip - 2
    (its preintegration still spans one gap), keyframe 0 fixed, bias priors
    (1, 1e2) on every slot."""
    prob, _ = make_problem(W=W, kf_every=20, noise_pose=0.01, noise_v=0.05,
                           seed=seed, n_lm=96)
    valid = np.asarray(prob.e_valid).copy()
    prev = np.asarray(prob.e_prev).copy()
    if skip is not None:
        prev[skip] = skip - 2
    valid[list(invalid)] = False
    prev = np.where(valid, prev, 0)
    prior = np.tile(np.float32([1.0] * 3 + [1e2] * 3), (W, 1))
    return prob._replace(e_valid=jnp.asarray(valid),
                         e_prev=jnp.asarray(prev, jnp.int32),
                         prior_bias_info=jnp.asarray(prior))


def _np_system(prob, Hpp, bp):
    """The reference `_lm_step`'s dense system before the landmark Schur
    step (vi_ba.py:278-321), in float64 numpy from JAX's `_edge_terms`."""
    jr, jJ = jax.jit(j_vi_ba._edge_terms)(prob, prob.R_wb, prob.p_wb,
                                          prob.v, prob.bias)
    r, J = np.asarray(jr, np.float64), np.asarray(jJ, np.float64)
    info = np.asarray(prob.e_info, np.float64)
    W = r.shape[0]
    JtW = np.einsum('eai,eab->ebi', J, info)
    He = np.einsum('ebi,ebj->eij', JtW, J)
    ge = -np.einsum('ebi,eb->ei', JtW, r)
    H = np.zeros((W, 15, W, 15))
    b = np.zeros((W, 15))
    prev = np.clip(np.asarray(prob.e_prev), 0, None)
    valid = np.asarray(prob.e_valid, np.float64)
    bias = np.asarray(prob.bias, np.float64)
    rw = np.asarray(prob.e_rw_info, np.float64) * valid[:, None]
    r_rw = (bias - bias[prev]) * valid[:, None]
    prior = np.asarray(prob.prior_bias_info, np.float64)
    for k in range(W):
        H[k, :6, k, :6] += Hpp[k]
        b[k, :6] += bp[k]
    for e in range(W):
        i = prev[e]
        H[i, :, i, :] += He[e, :15, :15]
        H[i, :, e, :] += He[e, :15, 15:]
        H[e, :, i, :] += He[e, :15, 15:].T
        H[e, :, e, :] += He[e, 15:, 15:]
        b[i] += ge[e, :15]
        b[e] += ge[e, 15:]
        d = np.diag(rw[e])
        H[i, 9:, i, 9:] += d
        H[e, 9:, e, 9:] += d
        H[i, 9:, e, 9:] -= d
        H[e, 9:, i, 9:] -= d
        b[i, 9:] += rw[e] * r_rw[e]
        b[e, 9:] += -rw[e] * r_rw[e]
    for k in range(W):
        H[k, 9:, k, 9:] += np.diag(prior[k])
        b[k, 9:] += -prior[k] * bias[k]
    return H.reshape(15 * W, 15 * W), b.reshape(15 * W)


def _scaled_gaps(H, b, H0, b0):
    """max |dH_ij| / sqrt(H_ii H_jj) and max |db_i| / sqrt(H_ii) over the
    scaled max-abs of b0, with the reference's diagonal."""
    d = np.sqrt(np.clip(np.diagonal(H0), 1e-30, None))
    eH = np.max(np.abs(H - H0) / d[:, None] / d[None, :])
    eb = np.max(np.abs(b - b0) / d) / np.max(np.abs(b0) / d)
    return eH, eb


@pytest.mark.parametrize("W,skip,invalid,seed", [(14, 6, (9,), 14),
                                                 (32, None, (20,), 7)])
def test_inertial_system_and_cost_match_reference(W, skip, invalid, seed):
    prob = _window_case(W, skip, invalid, seed)
    rng = np.random.default_rng(W)
    B = rng.normal(size=(W, 6, 6))
    Hpp = (1e5 * (B @ B.transpose(0, 2, 1) + np.eye(6))).astype(np.float32)
    bp = rng.normal(0, 1e3, (W, 6)).astype(np.float32)
    H0, b0 = _np_system(prob, Hpp.astype(np.float64), bp.astype(np.float64))
    tp = _port(prob)
    st = (tp.R_wb, tp.p_wb, tp.v, tp.bias)
    H, b = vi_ba.inertial_system_plain(tp, *st, torch.from_numpy(Hpp),
                                       torch.from_numpy(bp))
    eH, eb = _scaled_gaps(H.double().numpy(), b.double().numpy(), H0, b0)
    assert eH < 1e-5 and eb < 1e-5, (eH, eb)
    c0 = float(jax.jit(j_vi_ba._quad_costs)(prob, prob.R_wb, prob.p_wb,
                                            prob.v, prob.bias))
    c = float(vi_ba.inertial_cost_plain(tp, *st))
    assert abs(c - c0) <= 1e-4 * abs(c0), (c, c0)


def test_vi_ba_solve_window32_matches_reference():
    prob = _window_case(32, None, (20,), 7)
    jo = j_vi_ba.vi_ba_solve(prob, n_iters=6)
    to = vi_ba.vi_ba_solve(_port(prob), n_iters=6)
    for name, a, b, tol in zip(("R", "p", "v", "bias", "X"), to[:5], jo[:5],
                               (1e-4, 1e-4, 1e-4, 1e-5, 1e-4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol,
                                   err_msg=name)
    np.testing.assert_allclose(to[5]["costs"].numpy(),
                               np.asarray(jo[5]["costs"]), rtol=1e-3,
                               atol=1e-5 * float(jo[5]["cost0"]))
    np.testing.assert_allclose(float(to[5]["cost0"]),
                               float(jo[5]["cost0"]), rtol=1e-3)
