"""Persistence through the PyTorch port on the CPU (its plain kernel
versions), at the JAX tests' gates:

- the System lifecycle (tests/test_system.py:24): track 40 frames, write
  the frame and keyframe trajectories, read the map's points, save the
  Atlas, load it into a fresh System (by `load_atlas` and by
  `settings.load_atlas` at construction), relocalize in localization mode
  without adding a keyframe; the EuRoC, KITTI and sub-trajectory writers
  agree with the TUM file;
- the Atlas round trip with a stashed map (tests/test_atlas.py:134): track,
  stash, save, reload into a fresh Tracker, keep tracking over old ground,
  and the restored stash merges back.

The port's map of the lifecycle is built once for the module.
"""
import dataclasses

import numpy as np
import pytest
import torch

from morb_slam_tpu_torch import cameras, frontend, system
from morb_slam_tpu_torch.io import config, serialization, trajectory
from morb_slam_tpu_torch.pipeline import tracking
from morb_slam_tpu_torch.vocab import tree

from synthetic_world import PlaneWorld, camera_path

torch.set_num_threads(1)
W, H, FX = 384, 288, 300.0
K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
OVERRIDES = dict(max_kf=48, max_lm=6000, min_init_matches=60,
                 min_init_points=40)


def make_settings():
    s = config.Settings()
    s.cam1 = config.CameraSettings(model="PinHole", fx=FX, fy=FX,
                                   cx=W / 2, cy=H / 2, width=W, height=H)
    s.n_features = 500
    s.n_levels = 4
    return s


def _img(world, R, t):
    return torch.from_numpy(world.render(R, t))


def _vocabulary(world, poses):
    ocfg = frontend.OrbConfig(n_features=300, n_levels=4)
    descs = []
    for R, t in poses:
        f = frontend.extract_orb(_img(world, R, t), ocfg)
        descs.append(f.desc[f.valid].numpy().view(np.uint32))
    return tree.train(np.concatenate(descs), k=6, depth=3, iters=3)


@pytest.fixture(scope="module")
def lifecycle(tmp_path_factory):
    """The JAX lifecycle test's first session through the port: its
    vocabulary, the System after 40 frames and its saved outputs."""
    out = tmp_path_factory.mktemp("lifecycle")
    world = PlaneWorld(K, W, H, seed=0)
    poses = camera_path(40, step=0.05)
    voc = _vocabulary(world, poses[::8])
    sys1 = system.System(make_settings(), system.Sensor.MONOCULAR,
                         vocabulary=voc, tracker_overrides=OVERRIDES,
                         device="cpu")
    for i, (R, t) in enumerate(poses):
        sys1.track_monocular(_img(world, R, t), ts=float(i) * 0.05)
    paths = {k: str(out / k) for k in ("traj.txt", "kf.txt", "atlas",
                                       "traj.csv", "traj.kitti", "sub.txt")}
    sys1.save_trajectory_tum(paths["traj.txt"])
    sys1.save_keyframe_trajectory_tum(paths["kf.txt"])
    sys1.save_trajectory_euroc(paths["traj.csv"])
    sys1.save_trajectory_kitti(paths["traj.kitti"])
    sys1.save_sub_trajectory(paths["sub.txt"], 0.5, 1.0)
    sys1.save_atlas(paths["atlas"])
    return dict(world=world, poses=poses, voc=voc, sys1=sys1, paths=paths)


def _relocalize(sm, world, poses):
    states = []
    for i in (10, 11, 12, 13):
        R, t = poses[i]
        st, _ = sm.track_monocular(_img(world, R, t), ts=100.0 + i)
        states.append(st)
    return states


def test_system_lifecycle(lifecycle):
    sys1, paths = lifecycle["sys1"], lifecycle["paths"]
    assert sys1.state == "OK"
    assert len(open(paths["traj.txt"]).readlines()) > 30
    pc = sys1.map_point_cloud()
    assert pc.shape[0] > 200 and pc.shape[1] == 3

    # new session: load the atlas, localization-only, relocalize
    sys2 = system.System(make_settings(), system.Sensor.MONOCULAR,
                         vocabulary=lifecycle["voc"],
                         tracker_overrides=OVERRIDES, device="cpu")
    sys2.load_atlas(paths["atlas"])
    sys2.activate_localization_mode()
    assert sys2.state == "RECENTLY_LOST"
    n_kf_before = sys2.tracker.n_kf_host
    states = _relocalize(sys2, lifecycle["world"], lifecycle["poses"])
    assert "OK" in states, "failed to relocalize into the loaded atlas"
    assert sys2.tracker.n_kf_host == n_kf_before  # localization-only


def test_settings_load_atlas_at_construction(lifecycle):
    """`settings.load_atlas` restores the Atlas when the System is built:
    the same map, trajectory and counters as the session that saved it."""
    sys1 = lifecycle["sys1"]
    s = dataclasses.replace(make_settings(),
                            load_atlas=lifecycle["paths"]["atlas"])
    sys2 = system.System(s, system.Sensor.MONOCULAR,
                         vocabulary=lifecycle["voc"],
                         tracker_overrides=OVERRIDES, device="cpu")
    t1, t2 = sys1.tracker, sys2.tracker
    assert sys2.state == "RECENTLY_LOST"
    assert (t2.n_kf_host, t2.map_gen, len(t2.trajectory)) == \
        (t1.n_kf_host, t1.map_gen, len(t1.trajectory))
    for k in t1.m._fields:
        np.testing.assert_array_equal(getattr(t2.m, k).numpy(),
                                      getattr(t1.m, k).numpy(), err_msg=k)
    # the rebuilt database holds the same BoW vectors as the live one
    torch.testing.assert_close(t2.db.bow, t1.db.bow, rtol=0, atol=1e-7)
    assert torch.equal(t2.db.valid, t1.db.valid)
    sys2.activate_localization_mode()
    assert "OK" in _relocalize(sys2, lifecycle["world"], lifecycle["poses"])


def test_trajectory_writers_agree(lifecycle):
    """The EuRoC and KITTI files and the sub-trajectory hold the TUM file's
    poses; the keyframe file one pose per valid keyframe."""
    paths, sys1 = lifecycle["paths"], lifecycle["sys1"]
    ts, pos, quat = trajectory.read_tum(paths["traj.txt"])
    ts_e, pos_e, quat_e = trajectory.read_tum(paths["traj.csv"])
    # read_tum takes stamps above 1e14 for nanoseconds; these are smaller
    np.testing.assert_allclose(ts_e * 1e-9, ts, atol=1e-9)
    np.testing.assert_allclose(pos_e, pos, atol=1e-7)
    np.testing.assert_allclose(quat_e, quat, atol=1e-7)
    kitti = np.loadtxt(paths["traj.kitti"]).reshape(-1, 3, 4)
    np.testing.assert_allclose(kitti[:, :, 3], pos, atol=1e-6)
    ts_s, pos_s, _ = trajectory.read_tum(paths["sub.txt"])
    keep = (ts >= 0.5) & (ts <= 1.0)
    assert len(ts_s) == keep.sum() > 0
    np.testing.assert_allclose(pos_s, pos[keep], atol=1e-7)
    m = sys1.tracker.m
    n_kf = int(m.kf_valid[:int(m.n_kf)].sum())
    assert len(open(paths["kf.txt"]).readlines()) == n_kf
    # camera centres match the tracker's own resolved trajectory
    world = sys1.tracker.trajectory_world()
    np.testing.assert_allclose(pos, np.stack([p for _, p in world]),
                               atol=2e-6)


def test_atlas_save_load_revisit_merge(tmp_path):
    """Track, stash a map, save the Atlas, reload it into a fresh Tracker,
    keep tracking over old ground: the stash, databases and trajectory
    survive the round trip and the stashed map merges back."""
    cam = cameras.pinhole(FX, FX, W / 2, H / 2)
    world = PlaneWorld(K, W, H, seed=0)
    fwd = camera_path(24, step=0.05)
    seq = fwd + fwd[-2::-1]
    voc = _vocabulary(world, seq[::6])
    cfg = tracking.TrackerConfig(width=W, height=H, focal=FX, n_feat=500,
                                 max_kf=64, max_lm=8000, n_levels=4,
                                 min_init_matches=60, min_init_points=40)
    tr = tracking.Tracker(cam, cfg, voc=voc, device="cpu")
    cut = len(fwd)
    for i, (R, t) in enumerate(seq[:cut + 6]):
        if i == cut:
            tr.create_map_in_atlas()
        tr.track_mono(_img(world, R, t), ts=float(i))
    assert len(tr.stash) == 1
    tr.flush()
    n_traj_before = len(tr.trajectory)

    path = str(tmp_path / "atlas")
    serialization.save_atlas(path, tr, voc=voc)

    tr2 = tracking.Tracker(cam, cfg, voc=voc, device="cpu")
    serialization.load_atlas(path, tr2, voc=voc)
    assert len(tr2.stash) == 1
    assert tr2.map_gen == tr.map_gen
    assert len(tr2.trajectory) == n_traj_before
    assert tr2.stash[0].db is not None
    assert tr2.state == "RECENTLY_LOST"
    for i, (R, t) in enumerate(seq[cut + 6:], start=cut + 6):
        tr2.track_mono(_img(world, R, t), ts=float(i))
    merged = any(st.merged_into_gen >= 0 for st in tr2.stash)
    assert merged, "restored stash never merged on revisit"
    traj = tr2.trajectory_world()
    assert len(traj) > 0.5 * len(seq)
