"""IMU preintegration of the PyTorch port (K11's plain version on the CPU)
against the JAX package: fresh, continued and padded batches (dR, dV, dP
and the bias Jacobians within 1e-5, the covariance within 1e-5 of its
max-abs), the bias-corrected deltas and `predict_state`; plus the four
properties of test_imu.py run on the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morb_slam_tpu import imu as j_imu
from morb_slam_tpu_torch import convert, imu

from test_imu import simulate

torch.set_num_threads(1)
FREQ = 200.0
DT = 1.0 / FREQ
J_CALIB = j_imu.make_calib(np.eye(3), np.zeros(3), 1.7e-4, 2e-3, 1.9e-5,
                           3e-3, FREQ)
CALIB = convert.imu_from_numpy("ImuCalib", J_CALIB._asdict())

FIELDS = ("dR", "dV", "dP", "J_Rg", "J_Vg", "J_Va", "J_Pg", "J_Pa")


def _batch(seed, n, n_valid, bias_scale=0.0):
    rng = np.random.default_rng(seed)
    acc = (rng.normal(0, 1.5, (n, 3)) + [0, 0, 9.81]).astype(np.float32)
    gyr = rng.normal(0, 0.3, (n, 3)).astype(np.float32)
    dts = np.full(n, DT, np.float32)
    mask = np.arange(n) < n_valid
    bias = (rng.normal(0, 1, 6) * bias_scale).astype(np.float32)
    return acc, gyr, dts, mask, bias


def _both(acc, gyr, dts, mask, bias, init=None):
    j_init = None if init is None else init[0]
    t_init = None if init is None else init[1]
    jp = j_imu.preintegrate(jnp.asarray(acc), jnp.asarray(gyr),
                            jnp.asarray(dts), jnp.asarray(mask),
                            jnp.asarray(bias), J_CALIB, init=j_init)
    tp = imu.preintegrate(torch.from_numpy(acc), torch.from_numpy(gyr),
                          torch.from_numpy(dts), torch.from_numpy(mask),
                          torch.from_numpy(bias), CALIB, init=t_init)
    return jp, tp


def _agree(jp, tp):
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tp, f).numpy(),
                                   np.asarray(getattr(jp, f)), atol=1e-5,
                                   err_msg=f)
    C = np.asarray(jp.C)
    scale = max(float(np.abs(C).max()), 1e-30)
    np.testing.assert_allclose(tp.C.numpy() / scale, C / scale, atol=1e-5)
    np.testing.assert_allclose(float(tp.dt), float(jp.dt), rtol=1e-6)
    np.testing.assert_allclose(tp.avg_a.numpy(), np.asarray(jp.avg_a),
                               atol=1e-5)
    np.testing.assert_allclose(tp.avg_w.numpy(), np.asarray(jp.avg_w),
                               atol=1e-5)


@pytest.mark.parametrize("n,n_valid,bias_scale", [
    (64, 10, 0.0), (64, 64, 0.01), (768, 200, 0.02)])
def test_preintegrate_matches_reference(n, n_valid, bias_scale):
    """Fresh (all valid, and padded) batches: the frame batch and the
    keyframe buffer shapes."""
    _agree(*_both(*_batch(n_valid, n, n_valid, bias_scale)))


def test_preintegrate_continued_matches_reference():
    """`init=` continues the chain (the since-keyframe preintegration);
    the averages restart their count at 1."""
    acc, gyr, dts, mask, bias = _batch(3, 64, 12, 0.01)
    jp, tp = _both(acc, gyr, dts, mask, bias)
    acc2, gyr2, dts2, mask2, _ = _batch(4, 64, 9)
    jp2, tp2 = _both(acc2, gyr2, dts2, mask2, bias, init=(jp, tp))
    _agree(jp2, tp2)


def test_all_padding_batch_is_identity():
    acc, gyr, dts, mask, bias = _batch(5, 64, 0)
    jp, tp = _both(acc, gyr, dts, mask, bias)
    _agree(jp, tp)
    assert float(tp.dt) == 0.0
    assert torch.equal(tp.dR, torch.eye(3))


def test_deltas_and_predict_state_match_reference():
    acc, gyr, dts, mask, bias = _batch(6, 64, 20, 0.01)
    jp, tp = _both(acc, gyr, dts, mask, bias)
    nb = bias + np.array([0.003, -0.002, 0.004, 0.02, -0.015, 0.01],
                         np.float32)
    for name in ("delta_rotation", "delta_velocity", "delta_position"):
        np.testing.assert_allclose(
            getattr(imu, name)(tp, torch.from_numpy(nb)).numpy(),
            np.asarray(getattr(j_imu, name)(jp, jnp.asarray(nb))),
            atol=1e-5, err_msg=name)
    rng = np.random.default_rng(7)
    from scipy.spatial.transform import Rotation as Rot
    R = Rot.from_rotvec(rng.normal(0, 0.5, 3)).as_matrix().astype(np.float32)
    p = rng.normal(0, 1, 3).astype(np.float32)
    v = rng.normal(0, 1, 3).astype(np.float32)
    jo = j_imu.predict_state(jnp.asarray(R), jnp.asarray(p), jnp.asarray(v),
                             jnp.asarray(nb), jp)
    to = imu.predict_state(torch.from_numpy(R), torch.from_numpy(p),
                           torch.from_numpy(v), torch.from_numpy(nb), tp)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)


def test_imu_predict_matches_reference():
    """The tracker's dead-reckoning of a camera pose through one frame
    batch (`tracking.imu_predict`) against the JAX package's."""
    from morb_slam_tpu.pipeline import tracking as j_tr
    from morb_slam_tpu_torch.pipeline import tracking
    from scipy.spatial.transform import Rotation as Rot
    acc, gyr, dts, mask, bias = _batch(9, 64, 12, 0.01)
    rng = np.random.default_rng(9)
    R = Rot.from_rotvec(rng.normal(0, 0.5, 3)).as_matrix().astype(np.float32)
    t = rng.normal(0, 1, 3).astype(np.float32)
    v = rng.normal(0, 1, 3).astype(np.float32)
    jo = j_tr.imu_predict(jnp.asarray(R), jnp.asarray(t), jnp.asarray(v),
                          jnp.asarray(bias), jnp.asarray(acc),
                          jnp.asarray(gyr), jnp.asarray(dts),
                          jnp.asarray(mask), J_CALIB)
    to = tracking.imu_predict(*(torch.from_numpy(x) for x in (
        R, t, v, bias, acc, gyr, dts, mask)), CALIB)
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5)


def test_pack_round_trip():
    acc, gyr, dts, mask, bias = _batch(8, 16, 16, 0.01)
    _, tp = _both(acc, gyr, dts, mask, bias)
    buf = imu.pack(tp)
    assert buf.shape == (imu.PACK,)
    for a, b in zip(imu.unpack(buf), tp):
        assert torch.equal(a, b)


# ---- the properties of test_imu.py, on the port ---------------------------

def _pre(accs, gyros, dts, bias=None):
    n = len(dts)
    return imu.preintegrate(
        torch.tensor(accs, dtype=torch.float32),
        torch.tensor(gyros, dtype=torch.float32),
        torch.tensor(dts, dtype=torch.float32), torch.ones(n, dtype=torch.bool),
        torch.zeros(6) if bias is None else bias, CALIB)


def test_port_preintegrate_matches_analytic():
    accs, gyros, dts, RT, vT, pT = simulate()
    pre = _pre(accs, gyros, dts)
    Rj, pj, vj = imu.predict_state(torch.eye(3), torch.zeros(3),
                                   torch.tensor([0.1, 0.0, 0.05]),
                                   torch.zeros(6), pre)
    np.testing.assert_allclose(Rj.numpy(), RT, atol=2e-4)
    np.testing.assert_allclose(vj.numpy(), vT, atol=6e-3)
    np.testing.assert_allclose(pj.numpy(), pT, atol=3e-3)


def test_port_mask_padding_is_noop():
    accs, gyros, dts, *_ = simulate(T=0.2)
    n, pad = len(dts), 32
    pre1 = _pre(accs, gyros, dts)
    f = torch.float32
    pre2 = imu.preintegrate(
        torch.cat([torch.tensor(accs, dtype=f), torch.full((pad, 3), 1e3)]),
        torch.cat([torch.tensor(gyros, dtype=f), torch.full((pad, 3), 1e3)]),
        torch.cat([torch.tensor(dts, dtype=f), torch.full((pad,), 1e3)]),
        torch.arange(n + pad) < n, torch.zeros(6), CALIB)
    np.testing.assert_allclose(pre2.dR.numpy(), pre1.dR.numpy(), atol=1e-6)
    np.testing.assert_allclose(pre2.dP.numpy(), pre1.dP.numpy(), atol=1e-6)
    np.testing.assert_allclose(float(pre2.dt), float(pre1.dt), atol=1e-6)


def test_port_bias_jacobians_vs_reintegration():
    accs, gyros, dts, *_ = simulate(T=0.3)
    db = torch.tensor([0.003, -0.002, 0.004, 0.02, -0.015, 0.01])
    pre0 = _pre(accs, gyros, dts)
    pre1 = _pre(accs, gyros, dts, bias=db)
    np.testing.assert_allclose(imu.delta_rotation(pre0, db).numpy(),
                               pre1.dR.numpy(), atol=5e-4)
    np.testing.assert_allclose(imu.delta_velocity(pre0, db).numpy(),
                               pre1.dV.numpy(), atol=2e-3)
    np.testing.assert_allclose(imu.delta_position(pre0, db).numpy(),
                               pre1.dP.numpy(), atol=1e-3)


def test_port_covariance_grows_and_spd():
    accs, gyros, dts, *_ = simulate(T=0.3)
    n = len(dts)
    C = _pre(accs, gyros, dts).C.numpy().astype(np.float64)
    assert np.allclose(C, C.T, atol=1e-10)
    assert (np.linalg.eigvalsh(C[:9, :9]) > 0).all()
    C2 = _pre(accs[:n // 2], gyros[:n // 2], dts[:n // 2]).C.numpy()
    assert np.trace(C2[:9, :9]) < np.trace(C[:9, :9])
