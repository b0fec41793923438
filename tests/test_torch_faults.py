"""Fault injection through the PyTorch port's Tracker on the CPU (plain
kernel versions), mirroring tests/test_faults.py scenario by scenario with
its frames, settings and assertions: a timestamp jump starts a fresh map
(or resets a young one), a burst of pure-noise frames goes RECENTLY_LOST
and recovers, dropped frames recover, garbage IMU triggers the bad-IMU
reset, IMU dead reckoning carries the pose through a visual dropout, and
keyframe slots recycle past max_kf on a monocular map and on an
IMU-initialized stereo-inertial map (whose preintegration chain must stay
intact and whose SE3 ATE stays under 0.08 m).

One file for the seven, longest first (~12 minutes of one CPU core in
all, ~6 of them the 200 stereo-inertial frames of the first):
pytest-xdist's `--dist loadfile` hands files to its workers in order of
their test count, most first, so a long scenario in a file of its own
would start last and stretch the run's tail; and a worker takes its next
file once two tests of this one are left, so the long ones run first
while the rest of the run fills the other workers.
"""
import numpy as np
import torch
from scipy.spatial.transform import Rotation as Rot

from morb_slam_tpu_torch import alignment, cameras, imu, lie
from morb_slam_tpu_torch.pipeline import tracking

from synthetic_world import PlaneWorld, analytic_pose, camera_path, \
    imu_between

torch.set_num_threads(1)
W, H, FX = 384, 288, 300.0
K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])


def _world():
    return PlaneWorld(K, W, H, seed=0)


def _cam():
    return cameras.pinhole(FX, FX, W / 2, H / 2)


def _calib():
    return imu.make_calib(np.eye(3), np.zeros(3), 1.7e-4, 2e-3, 1.9e-5,
                          3e-3, 200.0)


def _mono_tracker(**kw):
    cfg = tracking.TrackerConfig(width=W, height=H, focal=FX, n_feat=500,
                                 max_kf=64, max_lm=8000, n_levels=4,
                                 min_init_matches=60, min_init_points=40,
                                 **kw)
    return _world(), tracking.Tracker(_cam(), cfg, device="cpu")


def _img(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_keyframe_slot_recycling_inertial():
    world = _world()
    b = 0.12
    max_kf = 14
    cfg = tracking.TrackerConfig(width=W, height=H, focal=FX, n_feat=500,
                                 max_kf=max_kf, max_lm=8000, n_levels=4,
                                 baseline=b, min_stereo_init_feats=200,
                                 max_kf_interval=6)
    tr = tracking.Tracker(_cam(), cfg, device="cpu", imu_calib=_calib())

    def pose_fn(t):
        center = np.array([0.5 + 0.5 * np.sin(1.2 * t),
                           0.15 * np.sin(1.9 * t),
                           0.08 * np.sin(2.4 * t)])
        R_cw = Rot.from_rotvec([0.0, 0.05 * np.sin(0.5 * t), 0.0]
                               ).as_matrix().T
        return R_cw, -R_cw @ center

    rng = np.random.default_rng(3)
    prev_t = -0.05
    states, gt = [], []
    for i in range(200):
        t = i * 0.05
        R, tc = pose_fn(t)
        gt.append(-(R.T @ tc))
        il = world.render(R.astype(np.float32), tc.astype(np.float32))
        ir = world.render(R.astype(np.float32),
                          (tc - np.asarray([b, 0, 0])).astype(np.float32))
        ts_i, acc, gyr = imu_between(prev_t, t, rng=rng, noise_g=2.4e-3,
                                     noise_a=2.8e-2, pose_fn=pose_fn)
        st, _ = tr.track_stereo_inertial(_img(il), _img(ir), t, acc, gyr,
                                         ts_i)
        states.append(st)
        prev_t = t
    tr.flush()
    assert tr.imu_ready, "IMU must initialize in this sequence"
    ok = sum(1 for s in states if s == "OK")
    assert ok > 0.8 * len(states), (ok, len(states))
    assert tr.kf_seq > max_kf + 2, (tr.kf_seq, max_kf)
    assert tr.n_kf_host <= max_kf
    traj = tr.trajectory_world()
    est = np.asarray([p for _, p in traj])
    assert np.isfinite(est).all()
    gtp = np.asarray([gt[int(round(ts / 0.05))] for ts, _ in traj])
    rmse, _, _, _ = alignment.ate_rmse(
        torch.tensor(est, dtype=torch.float32),
        torch.tensor(gtp, dtype=torch.float32), with_scale=False)
    assert float(rmse) < 0.08, float(rmse)
    # the preintegration chain stays intact: every valid interval's prev
    # points at a live keyframe
    valid = tr.kf_imu.valid.numpy()
    prev = tr.kf_imu.prev.numpy()
    kf_valid = tr.m.kf_valid.numpy()
    for k in np.nonzero(valid)[0]:
        assert prev[k] >= 0 and kf_valid[prev[k]], (k, prev[k])


def test_keyframe_slot_recycling():
    world = _world()
    max_kf = 12
    cfg = tracking.TrackerConfig(width=W, height=H, focal=FX, n_feat=500,
                                 max_kf=max_kf, max_lm=8000, n_levels=4,
                                 min_init_matches=60, min_init_points=40,
                                 max_kf_interval=6)
    tr = tracking.Tracker(_cam(), cfg, device="cpu")
    states = []
    for i in range(170):
        # oscillate over mapped ground (parallax-rich but redundant)
        x = 0.55 + 0.55 * np.sin(i * 0.09)
        center = np.array([x, 0.0, 0.0], np.float32)
        yaw = 0.05 * np.sin(i * 0.05)
        R_wc = lie.so3_exp(torch.tensor([0.0, yaw, 0.0])).numpy()
        R_cw = R_wc.T.astype(np.float32)
        t_cw = (-R_cw @ center).astype(np.float32)
        st, _ = tr.track_mono(_img(world.render(R_cw, t_cw)), ts=float(i))
        states.append(st)
    tr.flush()
    ok = sum(1 for s in states if s == "OK")
    assert ok > 0.8 * len(states), (ok, len(states))
    # total inserts far beyond capacity => slots were recycled
    assert tr.kf_seq > max_kf + 3, (tr.kf_seq, max_kf)
    assert tr.n_kf_host <= max_kf
    pts = np.asarray([p for _, p in tr.trajectory_world()])
    assert np.isfinite(pts).all()


def test_imu_dead_reckoning_through_dropout():
    """After IMU init, 0.5 s of black frames do not lose the map: the pose
    dead-reckons from the preintegration chain, trajectory entries keep
    flowing, and tracking re-acquires when imagery returns."""
    world = _world()
    b = 0.12
    cfg = tracking.TrackerConfig(width=W, height=H, focal=FX, n_feat=500,
                                 max_kf=96, max_lm=8000, n_levels=4,
                                 baseline=b, min_stereo_init_feats=200)
    tr = tracking.Tracker(_cam(), cfg, device="cpu", imu_calib=_calib())
    rng = np.random.default_rng(1)
    prev_t = -0.05
    black = np.zeros((H, W), np.float32)
    states = []
    dropout = range(42, 52)          # 0.5 s of visual dropout
    for i in range(75):
        t = i * 0.05
        R, tc = analytic_pose(t)
        if i in dropout:
            il = ir = black
        else:
            il = world.render(R.astype(np.float32), tc.astype(np.float32))
            ir = world.render(R.astype(np.float32),
                              (tc - np.asarray([b, 0, 0])).astype(
                                  np.float32))
        ts_i, acc, gyr = imu_between(prev_t, t, rng=rng, noise_g=2.4e-3,
                                     noise_a=2.8e-2)
        st, _ = tr.track_stereo_inertial(_img(il), _img(ir), t, acc, gyr,
                                         ts_i)
        states.append(st)
        if i == min(dropout) - 1:
            assert tr.imu_ready, "IMU must be initialized before dropout"
        prev_t = t
    assert "LOST" not in states, states
    assert all(states[i] in ("OK", "RECENTLY_LOST") for i in dropout)
    assert states[-1] == "OK", states[-10:]
    tr.flush()
    assert len(tr.trajectory) >= 70


def test_timestamp_jump_starts_fresh_map():
    world, tr = _mono_tracker()
    seq = camera_path(40, step=0.05)
    gen0 = tr.map_gen
    for i, (R, t) in enumerate(seq):
        ts = float(i)
        if i >= 25:
            ts = float(i) + 100.0      # 100-frame hole in the timeline
        tr.track_mono(_img(world.render(R, t)), ts=ts)
    # either a new map generation (mature) or a reset (young) happened
    assert tr.map_gen > gen0 or tr.n_kf_host < 10
    assert tr.state in ("OK", "NOT_INITIALIZED", "RECENTLY_LOST")


def test_corrupt_frames_recover():
    world, tr = _mono_tracker()
    rng = np.random.default_rng(3)
    seq = camera_path(45, step=0.05)
    states = []
    for i, (R, t) in enumerate(seq):
        if 25 <= i < 28:
            img = rng.uniform(0, 255, (H, W)).astype(np.float32)
        else:
            img = world.render(R, t)
        state, _ = tr.track_mono(_img(img), ts=float(i) * 0.05)
        states.append(state)
    assert "RECENTLY_LOST" in states[25:31], states[20:35]
    assert states[-1] == "OK" or "OK" in states[-5:], states[-8:]


def test_dropped_frames_recover():
    world, tr = _mono_tracker(ts_jump=10.0)   # keep timestamps acceptable
    seq = camera_path(50, step=0.05)
    states = []
    for i, (R, t) in enumerate(seq):
        if 25 <= i < 35:
            continue                    # frames lost in transmission
        state, _ = tr.track_mono(_img(world.render(R, t)),
                                 ts=float(i) * 0.05)
        states.append(state)
    ok_tail = sum(1 for s in states[-8:] if s == "OK")
    assert ok_tail >= 4, states[-10:]


def test_bad_imu_forced_reset():
    """Garbage IMU (init can never succeed) triggers the bad-IMU forced
    reset instead of poisoning the map forever."""
    world = _world()
    cfg = tracking.TrackerConfig(width=W, height=H, focal=FX, n_feat=500,
                                 max_kf=64, max_lm=8000, n_levels=4,
                                 min_init_matches=60, min_init_points=40,
                                 bad_imu_timeout=1.5)
    tr = tracking.Tracker(_cam(), cfg, device="cpu", imu_calib=_calib())
    rng = np.random.default_rng(5)
    prev_t = -0.05
    for i in range(60):
        t = i * 0.05
        R, tc = analytic_pose(t)
        img = world.render(R.astype(np.float32), tc.astype(np.float32))
        ts_i, acc, gyr = imu_between(prev_t, t, rng=rng)
        acc = rng.uniform(-60, 60, acc.shape)    # garbage accelerometer
        gyr = rng.uniform(-8, 8, gyr.shape)
        tr.track_mono_inertial(_img(img), t, acc, gyr, ts_i)
        prev_t = t
        if getattr(tr, "bad_imu", False):
            break
    assert getattr(tr, "bad_imu", False), "bad-IMU reset never fired"
    assert not tr.imu_ready
