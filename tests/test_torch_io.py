"""The PyTorch port's I/O against the JAX package (mirrors tests/test_io.py
:81, :94, :109, :117, :142 and :158 through the port): TUM / EuRoC / KITTI
trajectory writers and reader, timestamp association, the ATE CLI, map
checkpoints and the vocabulary checksum guard. Across the packages: the
same poses written by both packages' writers read back equal within 1e-6,
`vocab_checksum` gives one hex digest for one trained vocabulary, and a
random MapState saved by either package's `save_map` loads field-equal in
the other (descriptor words as uint32 on disk, the port's int32 view in
memory).
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morb_slam_tpu.io import serialization as j_ser
from morb_slam_tpu.io import trajectory as j_traj
from morb_slam_tpu.mapstate import state as j_ms
from morb_slam_tpu.vocab import tree as j_tree
from morb_slam_tpu_torch import convert, lie
from morb_slam_tpu_torch.eval import ate
from morb_slam_tpu_torch.io import serialization, trajectory
from morb_slam_tpu_torch.mapstate import state as ms
from morb_slam_tpu_torch.vocab import tree

torch.set_num_threads(1)


def make_poses(n=10):
    rng = np.random.default_rng(5)
    out = []
    for k in range(n):
        R, t = lie.se3_exp(torch.tensor(rng.normal(0, 0.3, 6),
                                        dtype=torch.float32))
        out.append((k * 0.05, R, t))
    return out


def _numpy_poses(poses):
    return [(ts, R.numpy(), t.numpy()) for ts, R, t in poses]


def test_tum_roundtrip(tmp_path):
    poses = make_poses()
    p = str(tmp_path / "traj.txt")
    trajectory.write_tum(p, poses)
    ts, pos, quat = trajectory.read_tum(p)
    assert len(ts) == 10
    Rwc = poses[3][1].numpy().T
    twc = -Rwc @ poses[3][2].numpy()
    np.testing.assert_allclose(pos[3], twc, atol=1e-5)
    R_read = lie.quat_to_rotmat(torch.tensor(quat[3],
                                             dtype=torch.float32)).numpy()
    np.testing.assert_allclose(R_read, Rwc, atol=1e-5)


def test_euroc_and_kitti_write(tmp_path):
    poses = make_poses()
    trajectory.write_euroc(str(tmp_path / "e.csv"), poses)
    ts, pos, quat = trajectory.read_tum(str(tmp_path / "e.csv"))
    assert len(ts) == 10
    Rwc = poses[2][1].numpy().T
    twc = -Rwc @ poses[2][2].numpy()
    np.testing.assert_allclose(pos[2], twc, atol=1e-5)
    R_read = lie.quat_to_rotmat(torch.tensor(quat[2],
                                             dtype=torch.float32)).numpy()
    np.testing.assert_allclose(R_read, Rwc, atol=1e-4)
    trajectory.write_kitti(str(tmp_path / "k.txt"), poses)
    lines = open(tmp_path / "k.txt").read().strip().split("\n")
    assert len(lines) == 10 and len(lines[0].split()) == 12


def test_associate():
    ts_a = np.asarray([0.0, 0.1, 0.2, 0.35])
    ts_b = np.asarray([0.01, 0.11, 0.24, 0.34, 0.5])
    ia, ib = trajectory.associate(ts_a, ts_b)
    assert list(ia) == [0, 1, 3]
    assert list(ib) == [0, 1, 3]


def _sim3_poses(tmp_path):
    poses = make_poses(30)
    gt = str(tmp_path / "gt.txt")
    trajectory.write_tum(gt, poses)
    s, Rg, tg = lie.sim3_exp(torch.tensor([.1, -.2, .3, .05, .1, -.02, .15]))
    est_poses = []
    for ts, R, t in poses:
        # move the camera centre, keep the rotation (ATE reads positions)
        Rwc = R.T
        c2 = lie.sim3_apply(s, Rg, tg, -(Rwc @ t))
        est_poses.append((ts, R, -(R @ c2)))
    est = str(tmp_path / "est.txt")
    trajectory.write_tum(est, est_poses)
    return gt, est, float(s)


def test_ate_cli(tmp_path):
    gt, est, s = _sim3_poses(tmp_path)
    out = ate.evaluate(gt, est, with_scale=True, device="cpu")
    assert out["pairs"] == 30
    assert out["rmse"] < 1e-4
    np.testing.assert_allclose(out["scale"], 1.0 / s, rtol=1e-4)


def test_ate_cli_entry_point(tmp_path):
    """`python -m morb_slam_tpu_torch.eval.ate gt est --scale` prints the
    pairs, the RMSE and the scale."""
    gt, est, s = _sim3_poses(tmp_path)
    out = subprocess.run([sys.executable, "-m", "morb_slam_tpu_torch.eval.ate",
                          gt, est, "--scale", "--device", "cpu"],
                         capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "compared_pose_pairs 30 pairs"
    assert float(lines[1].split()[1]) < 1e-4
    assert abs(float(lines[2].split()[1]) - 1.0 / s) < 1e-4


def _random_map():
    m = ms.empty_map(8, 64, 256)
    rng = np.random.default_rng(6)
    return m._replace(
        lm_pos=torch.tensor(rng.normal(size=(256, 3)), dtype=torch.float32),
        lm_valid=torch.tensor(rng.random(256) > 0.5),
        lm_desc=torch.tensor(rng.integers(-2 ** 31, 2 ** 31, (256, 8)),
                             dtype=torch.int32),
        kf_feat_desc=torch.tensor(rng.integers(-2 ** 31, 2 ** 31, (8, 64, 8)),
                                  dtype=torch.int32),
        kf_valid=torch.ones(8, dtype=torch.bool),
        n_kf=torch.tensor(8, dtype=torch.int32),
        n_lm=torch.tensor(100, dtype=torch.int32))


def test_map_serialization_roundtrip(tmp_path):
    m = _random_map()
    path = str(tmp_path / "map")
    serialization.save_map(path, m, meta={"seq": "test"})
    m2 = serialization.load_map(path)
    for k in m._fields:
        a, b = getattr(m, k), getattr(m2, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)


def test_vocab_checksum_guard(tmp_path):
    rng = np.random.default_rng(7)
    d = rng.integers(0, 2 ** 32, (500, 8), dtype=np.uint32)
    voc1 = tree.train(d, k=3, depth=2, iters=2, seed=0)
    voc2 = tree.train(d, k=3, depth=2, iters=2, seed=1)
    m = ms.empty_map(4, 16, 64)
    path = str(tmp_path / "map")
    serialization.save_map(path, m, voc=voc1)
    serialization.load_map(path, voc=voc1)  # ok
    with pytest.raises(ValueError):
        serialization.load_map(path, voc=voc2)


@pytest.mark.parametrize("fmt", ["tum", "euroc", "kitti"])
def test_trajectory_files_agree_across_packages(tmp_path, fmt):
    """The same poses through both packages' writer: each file reads back
    (TUM and EuRoC by either package's reader, KITTI as numbers) equal
    within 1e-6."""
    poses = _numpy_poses(make_poses(12))
    jp, tp = str(tmp_path / f"j.{fmt}"), str(tmp_path / f"t.{fmt}")
    getattr(j_traj, f"write_{fmt}")(
        jp, [(ts, jnp.asarray(R), jnp.asarray(t)) for ts, R, t in poses])
    getattr(trajectory, f"write_{fmt}")(
        tp, [(ts, torch.from_numpy(R), torch.from_numpy(t))
             for ts, R, t in poses])
    if fmt == "kitti":
        np.testing.assert_allclose(np.loadtxt(tp), np.loadtxt(jp), atol=1e-6)
        return
    for a, b in zip(trajectory.read_tum(tp), j_traj.read_tum(jp)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    for a, b in zip(trajectory.read_tum(jp), j_traj.read_tum(tp)):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_vocab_checksum_matches_jax():
    rng = np.random.default_rng(8)
    d = rng.integers(0, 2 ** 32, (600, 8), dtype=np.uint32)
    jv = j_tree.train(d, k=4, depth=2, iters=2, seed=3)
    tv = convert.vocab_from_numpy(dict(
        centers=[np.asarray(c) for c in jv.centers],
        weights=np.asarray(jv.weights), k=jv.k))
    assert serialization.vocab_checksum(tv) == j_ser.vocab_checksum(jv)
    # and the port's own training of the same descriptors
    assert serialization.vocab_checksum(
        tree.train(d, k=4, depth=2, iters=2, seed=3)) == \
        j_ser.vocab_checksum(jv)


def test_map_files_cross_packages(tmp_path):
    """A random map saved by the JAX package loads field-equal in the
    port, and one saved by the port loads field-equal in the JAX package,
    with the vocabulary checksum of a shared vocabulary accepted by both."""
    rng = np.random.default_rng(9)
    d = rng.integers(0, 2 ** 32, (400, 8), dtype=np.uint32)
    jv = j_tree.train(d, k=3, depth=2, iters=2, seed=0)
    tv = convert.vocab_from_numpy(dict(
        centers=[np.asarray(c) for c in jv.centers],
        weights=np.asarray(jv.weights), k=jv.k))
    m = _random_map()
    m_np = convert.map_to_numpy(m)
    jm = j_ms.MapState(**{k: jnp.asarray(v) for k, v in m_np.items()})

    jpath = str(tmp_path / "jmap")
    j_ser.save_map(jpath, jm, voc=jv)
    got = serialization.load_map(jpath, voc=tv)
    for k in m._fields:
        assert getattr(got, k).dtype == getattr(m, k).dtype, k
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      getattr(m, k).numpy(), err_msg=k)

    tpath = str(tmp_path / "tmap")
    serialization.save_map(tpath, m, voc=tv)
    back = j_ser.load_map(tpath, voc=jv)
    for k in m._fields:
        a, b = np.asarray(getattr(back, k)), np.asarray(getattr(jm, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
