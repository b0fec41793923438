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
arguments of its last solve (the marginal's) come back to the host."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morb_slam_tpu.optim import vi_ba as j_vi_ba
from morb_slam_tpu_torch.optim import vi_ba

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
