"""The last public helpers of the JAX package in the port, against the JAX
package on the CPU: `ops/hamming.py` hamming_matrix_mxu (K19's plain
version: equal to JAX's hamming_matrix_mxu and to both packages'
hamming_matrix, exactly), `ops/fast.py` fast_corners (the same mask on
test_frontend.py's textured image), `optim/robust.py` cauchy_weight
(within 1 ulp) and `optim/inertial.py` inertial_residuals (on
test_inertial.py's preintegrations, within 1e-5 relative)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rot

from morb_slam_tpu.ops import fast as j_fast
from morb_slam_tpu.ops import hamming as j_hamming
from morb_slam_tpu.optim import inertial as j_in
from morb_slam_tpu.optim import robust as j_robust
from morb_slam_tpu_torch import convert
from morb_slam_tpu_torch.ops import fast, hamming
from morb_slam_tpu_torch.optim import inertial, robust

from test_frontend import synthetic_image
from test_inertial import G0, build_kf_imu, simulate_rich

torch.set_num_threads(1)


@pytest.mark.parametrize("n,m", [(300, 257), (64, 64), (1, 9)])
def test_hamming_matrix_mxu_matches_reference(n, m):
    rng = np.random.default_rng(n + m)
    a = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32)
    b[: m // 3] = a[: m // 3] ^ (1 << rng.integers(0, 32, (m // 3, 8))
                                 ).astype(np.uint32)
    want = np.asarray(j_hamming.hamming_matrix(jnp.asarray(a),
                                               jnp.asarray(b)))
    np.testing.assert_array_equal(
        np.asarray(j_hamming.hamming_matrix_mxu(jnp.asarray(a),
                                                jnp.asarray(b))), want)
    ta, tb = (torch.from_numpy(x.view(np.int32)) for x in (a, b))
    before = dict(hamming.MXU_LAUNCHES)
    got = hamming.hamming_matrix_mxu(ta, tb)
    assert hamming.MXU_LAUNCHES == {"kernel": before["kernel"],
                                    "plain": before["plain"] + 1}
    assert got.dtype == torch.int32 and got.shape == (n, m)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, hamming.hamming_matrix(ta, tb))


def test_fast_corners_matches_reference():
    img = synthetic_image()
    for th in (7.0, 20.0):
        want = np.asarray(j_fast.fast_corners(jnp.asarray(img, jnp.float32),
                                              th))
        got = fast.fast_corners(torch.from_numpy(img.astype(np.float32)), th)
        assert got.dtype == torch.bool and want.any()
        np.testing.assert_array_equal(got.numpy(), want)


def test_cauchy_weight_within_one_ulp():
    rng = np.random.default_rng(5)
    chi2 = np.concatenate([[0.0, 1e-12, 5.991, 7.815, 1e6],
                           rng.exponential(10.0, 500)]).astype(np.float32)
    delta2 = np.where(rng.random(chi2.size) < 0.5, 5.991,
                      7.815).astype(np.float32)
    want = np.asarray(j_robust.cauchy_weight(jnp.asarray(chi2),
                                             jnp.asarray(delta2)))
    got = robust.cauchy_weight(torch.from_numpy(chi2),
                               torch.from_numpy(delta2)).numpy()
    assert got.dtype == np.float32
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)


def test_inertial_residuals_matches_reference():
    """test_inertial.py:113's preintegrations (2 s, a keyframe every 50
    samples), scored on the true states in a rotated, scaled visual frame
    with biases off the integration point, and on the truth itself."""
    ts, p, v, R, acc, gyr = simulate_rich(T=2.0)
    ki, n_kf = build_kf_imu(ts, acc, gyr)
    idx = np.arange(n_kf) * 50
    R_vg = Rot.from_rotvec([0.2, 0.1, -0.3]).as_matrix()
    cases = [
        (np.einsum('ij,njk->nik', R_vg, R[idx]), (p[idx] @ R_vg.T) / 1.7,
         v[idx] @ R_vg.T, [0.004, -0.003, 0.002], [0.03, -0.02, 0.04],
         R_vg @ G0, 1.7),
        (R[idx], p[idx], v[idx], [0.0] * 3, [0.0] * 3, G0, 1.0)]
    tki = convert.imu_from_numpy(
        "KfImu", {k: np.asarray(x) for k, x in ki._asdict().items()})
    for R_wb, p_wb, vel, bg, ba, g, s in cases:
        args = [np.asarray(x, np.float32)
                for x in (R_wb, p_wb, vel, bg, ba, g, s)]
        want = np.asarray(j_in.inertial_residuals(
            ki, *(jnp.asarray(x) for x in args)))
        got = inertial.inertial_residuals(
            tki, *(torch.from_numpy(x) for x in args)).numpy()
        assert got.shape == (n_kf, 9) and not got[0].any()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    # the truth scores (near) zero, the shifted biases do not
    assert np.abs(got).max() < 0.05
