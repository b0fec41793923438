"""The structural fact K12's 15-dim design rests on, held in the JAX
package and in the port's plain version (CPU): with the anchor keyframe
fixed (`anchor_fixed=True`, the tracker's only mode), the final 30-dim
Hessian is diag(I, H_cc) exactly (anchor block I, cross blocks 0), so the
step never moves the anchor and the marginal is the symmetrized H_cc
itself (to float32 rounding). The CUDA kernel solves only the current
state's 15 dims and writes H_cc as H_marg; `tests/test_torch_kernels_gpu.py`
holds it against the plain version on the card.

Inputs: `test_torch_vi_ba.py`'s pose-inertial case (made from a seed with
numpy), cut to its first 60 observations, mono and half stereo. The JAX
function is traced anew with `jnp.linalg.solve` wrapped so that the
arguments of its last solve (the marginal's) come back to the host.

The plain version is also held bit for bit against its earlier form, whose
edge Jacobian came from `torch.func.jacfwd` (tests/k12_reference.py), on
three calls recorded from tests/test_torch_faults.py's stereo-inertial
recycling scenario (tests/data/k12_recycling_calls.npz) and on the two
seeded cases."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morb_slam_tpu.optim import vi_ba as j_vi_ba
from morb_slam_tpu_torch.optim import vi_ba

import k12_reference
from test_torch_vi_ba import _pose_inertial_case

torch.set_num_threads(1)
N_OBS = 60
SOLVES = []          # (a, b) of every jnp.linalg.solve the fresh trace runs
_solve = jnp.linalg.solve


def _recording_solve(a, b):
    jax.debug.callback(lambda a_, b_: SOLVES.append(
        (np.asarray(a_), np.asarray(b_))), a, b)
    return _solve(a, b)


# a jit of its own, traced with the recording solve at its first call
_j_optimize = jax.jit(j_vi_ba.optimize_pose_inertial.__wrapped__,
                      static_argnames=("n_iters", "anchor_fixed"))


def _case(stereo):
    args = _pose_inertial_case(stereo, seed=4)
    for k in range(4, 9):        # Xw, obs, info, valid, obs_ur
        args[k] = args[k][:N_OBS]
    return args


def _port_args(args):
    return [torch.from_numpy(np.array(a)) if a.dtype == np.bool_
            else torch.from_numpy(np.array(a, np.float32)) for a in args]


@pytest.mark.parametrize("stereo", [False, True])
def test_anchor_fixed_hessian_is_block_diagonal(stereo, monkeypatch):
    args = _case(stereo)
    eye15 = np.eye(15, dtype=np.float32)

    # the port's plain version: H_full as `_marginal` receives it
    seen = []
    marginal = vi_ba._marginal

    def capture(H_full):
        seen.append(H_full.clone())
        return marginal(H_full)
    monkeypatch.setattr(vi_ba, "_marginal", capture)
    res = vi_ba.optimize_pose_inertial(*_port_args(args), n_iters=6)
    H = seen[-1].numpy()
    assert np.array_equal(H[:15, :15], eye15)
    assert not H[:15, 15:].any() and not H[15:, :15].any()
    H_cc = H[15:, 15:]
    np.testing.assert_allclose(res.H_marg.numpy(), 0.5 * (H_cc + H_cc.T),
                               rtol=0, atol=1e-6 * np.abs(H_cc).max())
    assert int(res.n_inliers) > 30

    # the JAX package: the marginal's solve(H_aa + 1e-5 I, H_ac)
    monkeypatch.setattr(jnp.linalg, "solve", _recording_solve)
    SOLVES.clear()
    jo = _j_optimize(*[jnp.asarray(a) for a in args], n_iters=6)
    jax.effects_barrier()
    H_aa, H_ac = SOLVES[-1]
    assert np.array_equal(H_aa, eye15 + np.float32(1e-5) * eye15)
    assert not H_ac.any()
    # both packages' marginals agree (the plain version mirrors JAX)
    Hj = np.asarray(jo.H_marg)
    np.testing.assert_allclose(res.H_marg.numpy() / np.abs(Hj).max(),
                               Hj / np.abs(Hj).max(), atol=1e-4)


# K12's plain version against its jacfwd form (tests/k12_reference.py), bit
# for bit: three calls recorded from tests/test_torch_faults.py's
# stereo-inertial recycling scenario (its plain K12 calls 1, 80 and 158 of
# 158; tests/k12_scenario_bitwise.py checks all of them and writes the
# file anew), then this file's two seeded cases
_RECORDED = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                         "k12_recycling_calls.npz")
_ARGS = ("R0_cw", "t0_cw", "v0", "bias0", "Xw", "obs", "info", "valid",
         "obs_ur", "baseline", "R_a_wb", "p_a", "v_a", "bias_a", "e_dt",
         "e_dR", "e_dV", "e_dP", "e_JRg", "e_JVg", "e_JVa", "e_JPg", "e_JPa",
         "e_info", "e_bias0", "e_rw_info")


def _recorded(i):
    with np.load(_RECORDED) as d:
        return [torch.from_numpy(d[f"c{i}_{n}"]) for n in _ARGS]


@pytest.mark.parametrize("case", ["recorded0", "recorded1", "recorded2",
                                  "mono", "stereo"])
def test_plain_matches_jacfwd_form_bitwise(case):
    if case.startswith("recorded"):
        args, n_iters = _recorded(int(case[-1])), 6
    else:
        args, n_iters = _port_args(_case(case == "stereo")), 4
    got = vi_ba.optimize_pose_inertial_plain(*args, n_iters=n_iters)
    want = k12_reference.optimize_pose_inertial_jacfwd(*args,
                                                       n_iters=n_iters)
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert int(got.n_inliers) > 30
