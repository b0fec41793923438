"""The inertial loop branch of `LoopCloser.maybe_close` in the PyTorch port
(plain kernel versions, on the CPU) against the JAX package, on an inertial
variant of tests/test_loop_closing.py's drifted-revisit map built here:

- 20 keyframes 0.5 s apart on a smooth out-and-back path along x (a raised
  cosine, identity orientation); keyframes 10-19 revisit the first half's
  places through duplicate landmarks, and their poses, landmarks and world
  velocities carry a rigid drift: a rotation about the gravity axis (z)
  inside the 0.05 rad pitch / roll gate and a translation, scale drift 1;
- `kf_v` the path's velocity, `kf_bias` 0, a `KfImu` chain preintegrated
  by each package from the same noiseless samples of
  `synthetic_world.imu_between` with the path as `pose_fn`; the tracker's
  `imu_ready` set and its configuration inertial.

`maybe_close` runs for keyframes 18 and 19 in both packages, as
tests/test_loop_closing.py's test_loop_closes_on_drifted_revisit does.
Checked: the same fire / no-fire (no loop on the first detection, one on
the second) and so the same tilt-gate decision; the poses, velocities and
biases after correct_loop(four_dof) + search_and_fuse, as
full_inertial_ba receives them, within 1e-4 of JAX's (measured: 2.4e-7);
after full_inertial_ba, rotations within 1e-4, positions within 2e-3 m,
velocities within 1e-3 of their largest norm and biases within 1e-3 (the
float32 limit of this solve: its 10 LM iterations start 0.3 m from the
optimum, the first step's cost already differs by 4e-4 relative between
the packages through the float32 Cholesky of the Jacobi-scaled system,
and at the eighth iteration one package accepts the step the other
rejects while the cost still falls; the port's full_inertial_ba on JAX's
own input differs from JAX's output by 1.9e-3 m as well); the late
keyframes' centre RMSE under 0.4 x its value before; every keyframe's tilt
under 0.01 rad after. A drift of 0.08 rad in pitch is refused by the gate
in both packages, and the map does not move.

The same map drives the branch on the card in chip_smoke.py's vi_loop
phase (its own numpy copy of this construction). Run as a script, the file runs
that phase's ring circuit (tests/test_inertial_e2e.py:136's configuration,
300 stereo-inertial frames at 1.3 circuits) through the port's System on
the CPU or through the JAX tracker, and prints its gates (~6 min each):

    PYTHONPATH=.:tests python tests/test_torch_loop_inertial.py --package port|jax
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from morb_slam_tpu import cameras as j_cameras
from morb_slam_tpu import imu as j_imu
from morb_slam_tpu.mapstate import state as j_ms
from morb_slam_tpu.optim import inertial as j_inertial
from morb_slam_tpu.pipeline import local_mapping as j_local_mapping
from morb_slam_tpu.pipeline import loop_closing as j_lc
from morb_slam_tpu.pipeline import tracking as j_tracking
from morb_slam_tpu.vocab import database as j_kfdb
from morb_slam_tpu.vocab import tree as j_tree
from morb_slam_tpu_torch import cameras, convert, imu
from morb_slam_tpu_torch.optim import inertial
from morb_slam_tpu_torch.pipeline import local_mapping, loop_closing, tracking
from morb_slam_tpu_torch.vocab import database as kfdb
from morb_slam_tpu_torch.vocab import tree

from synthetic_world import imu_between

torch.set_num_threads(1)
N, DT, T_PATH, XM = 20, 0.5, 9.5, 3.8
MAX_KF, F, MAX_LM = 24, 256, 1024
W, H, FX = 384, 288, 300.0
CALIB = (np.eye(3), np.zeros(3), 1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)


def _rotvec(w):
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def path_pose(t):
    """(R_cw, t_cw) of the true path at t s."""
    x = XM * 0.5 * (1.0 - np.cos(2 * np.pi * t / T_PATH))
    return np.eye(3), -np.array([x, 0.0, 0.0])


def inertial_drifted_map(m_np, rot_drift, t_drift=(0.25, -0.1, 0.15),
                         seed=7):
    """Fill an empty map's numpy arrays with the inertial drifted-revisit
    state; returns (m_np, descriptors, true centres)."""
    rng = np.random.default_rng(seed)
    NP_ = 400
    Xw = np.stack([np.linspace(0, 12, NP_), rng.uniform(-1.2, 1.2, NP_),
                   rng.uniform(4.0, 6.0, NP_)], axis=1).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (NP_, 8), dtype=np.uint32)
    R_d = _rotvec(rot_drift).astype(np.float32)
    t_d = np.asarray(t_drift, np.float32)
    X_dup = (Xw @ R_d.T + t_d).astype(np.float32)
    centers, views = {}, {}
    for i in range(N):
        late = i >= N // 2
        t = i * DT
        c = -path_pose(t)[1].astype(np.float32)
        v = np.array([XM * np.pi / T_PATH * np.sin(2 * np.pi * t / T_PATH),
                      0.0, 0.0], np.float32)
        centers[i] = c
        vis = np.where(np.abs(Xw[:, 0] - c[0] - 1.2) < 2.2)[0][:F]
        views[i] = vis
        Xc = Xw[vis] - c                          # R_cw = I (true pose)
        if late:
            m_np["kf_R"][i] = R_d.T
            m_np["kf_t"][i] = -c - R_d.T @ t_d
            m_np["kf_v"][i] = R_d @ v
            lm_ids = 512 + vis
        else:
            m_np["kf_R"][i] = np.eye(3, dtype=np.float32)
            m_np["kf_t"][i] = -c
            m_np["kf_v"][i] = v
            lm_ids = vis
        n = len(vis)
        m_np["kf_valid"][i] = True
        m_np["kf_ts"][i] = t
        m_np["kf_prev"][i] = i - 1
        xn = Xc[:, :2] / Xc[:, 2:3]
        m_np["kf_feat_xn"][i, :n] = xn
        m_np["kf_feat_uv"][i, :n] = xn * FX + np.array([W / 2, H / 2],
                                                       np.float32)
        m_np["kf_feat_desc"][i, :n] = desc[vis]
        m_np["kf_feat_valid"][i, :n] = True
        m_np["kf_feat_lm"][i, :n] = lm_ids
    half = N // 2
    early = np.unique(np.concatenate([views[i] for i in range(half)]))
    late_ = np.unique(np.concatenate([views[i] for i in range(half, N)]))
    m_np["lm_pos"][early] = Xw[early]
    m_np["lm_valid"][early] = True
    m_np["lm_desc"][early] = desc[early]
    m_np["lm_pos"][512 + late_] = X_dup[late_]
    m_np["lm_valid"][512 + late_] = True
    m_np["lm_desc"][512 + late_] = desc[late_]
    m_np["lm_normal"][:, 2] = -1.0
    m_np["lm_dist_max"][:] = 12.0
    for i in range(N):
        ids = views[i] if i < half else 512 + views[i]
        first = m_np["lm_ref_kf"][ids] < 0
        m_np["lm_ref_kf"][ids[first]] = i
        m_np["lm_first_ts"][ids[first]] = i * DT
    m_np["n_kf"] = np.asarray(N)
    m_np["n_lm"] = np.asarray(912)
    return m_np, desc, centers


SAMPLES = [imu_between((k - 1) * DT, k * DT, pose_fn=path_pose)
           for k in range(1, N)]


def _jax_tracker(m_np, desc):
    voc = j_tree.train(desc, k=6, depth=3, iters=4)
    cfg = j_tracking.TrackerConfig(width=W, height=H, focal=FX, n_feat=F,
                                   max_kf=MAX_KF, max_lm=MAX_LM, n_levels=4)
    tr = j_tracking.Tracker(j_cameras.pinhole(FX, FX, W / 2, H / 2), cfg,
                            voc=voc, imu_calib=j_imu.make_calib(*CALIB))
    tr.m = j_ms.MapState(**{k: jnp.asarray(v) for k, v in m_np.items()})
    ki = j_inertial.empty_kf_imu(MAX_KF)
    preintegrate = jax.jit(j_imu.preintegrate)
    for k, (ts, acc, gyr) in enumerate(SAMPLES, start=1):
        n = len(ts)
        pre = preintegrate(jnp.asarray(acc), jnp.asarray(gyr),
                           jnp.full(n, 1.0 / CALIB[-1], jnp.float32),
                           jnp.ones(n, bool), jnp.zeros(6, jnp.float32),
                           tr.calib)
        ki = j_inertial.set_kf_imu(ki, k, pre, k - 1)
    tr.kf_imu, tr.imu_ready, tr.n_kf_host = ki, True, N
    bows = []
    for i in range(N):
        bow = j_tree.bow_vector(voc, j_tree.transform(
            voc, tr.m.kf_feat_desc[i], tr.m.kf_feat_valid[i]))
        tr.db = j_kfdb.add_keyframe(tr.db, i, bow)
        bows.append(bow)
    return tr, bows, j_lc.LoopCloser(tr.cfg)


def _port_tracker(m_np, desc):
    voc = tree.train(desc, k=6, depth=3, iters=4)
    cfg = tracking.TrackerConfig(width=W, height=H, focal=FX, n_feat=F,
                                 max_kf=MAX_KF, max_lm=MAX_LM, n_levels=4)
    tr = tracking.Tracker(cameras.pinhole(FX, FX, W / 2, H / 2), cfg,
                          device="cpu", voc=voc,
                          imu_calib=imu.make_calib(*CALIB))
    tr.m = convert.map_from_numpy(m_np)
    ki = inertial.empty_kf_imu(MAX_KF)
    for k, (ts, acc, gyr) in enumerate(SAMPLES, start=1):
        n = len(ts)
        pre = imu.preintegrate(torch.from_numpy(acc), torch.from_numpy(gyr),
                               torch.full((n,), 1.0 / CALIB[-1]),
                               torch.ones(n, dtype=torch.bool),
                               torch.zeros(6), tr.calib)
        ki = inertial.set_kf_imu(ki, k, pre, k - 1)
    tr.kf_imu, tr.imu_ready, tr.n_kf_host = ki, True, N
    bows = []
    for i in range(N):
        bow = tree.bow_vector(tr.voc, tree.transform(
            tr.voc, tr.m.kf_feat_desc[i], tr.m.kf_feat_valid[i]))
        tr.db = kfdb.add_keyframe(tr.db, i, bow)
        bows.append(bow)
    return tr, bows, loop_closing.LoopCloser(tr.cfg)


def _state(m):
    return {k: np.asarray(getattr(m, k), np.float64)[:N]
            for k in ("kf_R", "kf_t", "kf_v", "kf_bias")}


def _centre_rmse(st, centers):
    c = -np.einsum('kji,kj->ki', st["kf_R"][10:], st["kf_t"][10:])
    gt = np.stack([centers[i] for i in range(10, N)])
    return float(np.sqrt(np.mean(np.sum((c - gt) ** 2, axis=1))))


def _tilts(st):
    """Each keyframe's pitch / roll against the true (identity)
    orientation: the angle of R_est^T e_z from e_z."""
    v = st["kf_R"][:, 2, :]
    return np.arctan2(np.hypot(v[:, 0], v[:, 1]), v[:, 2])


def _run(rot_drift, monkeypatch):
    """maybe_close for keyframes 18 and 19 in both packages: fired, the
    keyframe states before, as full_inertial_ba received them, and
    after."""
    m0 = {k: np.asarray(v).copy()
          for k, v in j_ms.empty_map(MAX_KF, F, MAX_LM)._asdict().items()}
    m_np, desc, centers = inertial_drifted_map(m0, rot_drift)
    out = {}
    for name, make, mod in (("jax", _jax_tracker, j_local_mapping),
                            ("port", _port_tracker, local_mapping)):
        tr, bows, closer = make({k: v.copy() for k, v in m_np.items()}, desc)
        r = dict(before=_state(tr.m))

        def fiba(m, *a, _f=mod.full_inertial_ba, _r=r, **kw):
            _r["ba_in"] = _state(m)
            return _f(m, *a, **kw)
        monkeypatch.setattr(mod, "full_inertial_ba", fiba)
        r["fired"] = [bool(closer.maybe_close(tr, k, bows[k]))
                      for k in (18, 19)]
        r["after"] = _state(tr.m)
        out[name] = r
    return out, centers


def test_inertial_loop_branch_matches_reference(monkeypatch):
    out, centers = _run((0.0, 0.0, 0.04), monkeypatch)
    j, t = out["jax"], out["port"]
    assert j["fired"] == t["fired"] == [False, True], (j["fired"],
                                                      t["fired"])
    for stage, tols in (("ba_in", (1e-4, 1e-4, 1e-4, 1e-4)),
                        ("after", (1e-4, 2e-3, 1e-3, 1e-3))):
        vmax = np.abs(j[stage]["kf_v"]).max()
        for k, tol in zip(("kf_R", "kf_t", "kf_v", "kf_bias"), tols):
            sc = vmax if k == "kf_v" else 1.0
            np.testing.assert_allclose(t[stage][k] / sc, j[stage][k] / sc,
                                       atol=tol, err_msg=f"{stage} {k}")
    for r in (j, t):
        before = _centre_rmse(r["before"], centers)
        after = _centre_rmse(r["after"], centers)
        assert before > 0.2 and after < 0.4 * before, (before, after)
        assert np.all(np.isfinite(r["after"]["kf_v"]))
        assert _tilts(r["after"]).max() < 0.01, _tilts(r["after"]).max()


def test_pitch_drift_refused_by_the_gate(monkeypatch):
    out, _ = _run((0.0, 0.08, 0.0), monkeypatch)
    for r in out.values():
        assert r["fired"] == [False, False], r["fired"]
        assert "ba_in" not in r
        for k in ("kf_R", "kf_t", "kf_v"):
            np.testing.assert_array_equal(r["after"][k], r["before"][k])


def ring_circuit(package, n_frames=300, circuits=1.3, b=0.1):
    """The ring-circuit gauge run: OK frames, imu_ready, the largest
    keyframe tilt, the mean circuit gap and the loops closed."""
    from functools import partial

    from synthetic_world import RingWorld, ring_path, ring_pose
    world = RingWorld(np.array([[FX, 0, W / 2], [0, FX, H / 2],
                                [0, 0, 1.0]]), W, H, seed=0)
    poses = ring_path(n_frames, circuits=circuits)
    pose_fn = partial(ring_pose, circuits=circuits, n_frames=n_frames)
    left = [world.render(R, t) for R, t in poses]
    if package == "jax":
        from morb_slam_tpu import frontend as j_frontend
        descs = [np.asarray(f.desc)[np.asarray(f.valid)] for f in (
            j_frontend.extract_orb(jnp.asarray(img), j_frontend.OrbConfig(
                n_features=500, n_levels=4)) for img in left[::25])]
        voc = j_tree.train(np.concatenate(descs), k=8, depth=3, iters=4)
        cfg = j_tracking.TrackerConfig(
            width=W, height=H, focal=FX, n_feat=500, max_kf=128,
            max_lm=16000, n_levels=4, baseline=b, th_depth=60.0,
            min_stereo_init_feats=150, vel_rot_damp=0.9)
        tr = j_tracking.Tracker(j_cameras.pinhole(FX, FX, W / 2, H / 2),
                                cfg, voc=voc,
                                imu_calib=j_imu.make_calib(*CALIB))

        def feed(i, img_l, img_r, ts_i, acc, gyr):
            return tr.track_stereo_inertial(img_l, img_r, i * 0.05, acc,
                                            gyr, ts_i)[0]
    else:
        from morb_slam_tpu_torch import frontend, system
        from morb_slam_tpu_torch.io import config
        descs = [f.desc[f.valid].numpy() for f in (
            frontend.extract_orb(torch.from_numpy(img), frontend.OrbConfig(
                n_features=500, n_levels=4)) for img in left[::25])]
        voc = tree.train(np.concatenate(descs).view(np.uint32), k=8,
                         depth=3, iters=4)
        settings = config.Settings(
            sensor="stereo-inertial",
            cam1=config.CameraSettings(model="Rectified", fx=FX, fy=FX,
                                       cx=W / 2, cy=H / 2, width=W,
                                       height=H),
            baseline=b, th_depth=60.0, imu=config.ImuSettings(),
            n_features=500, n_levels=4, scale_factor=1.2)
        sysm = system.System(settings, system.Sensor.IMU_STEREO,
                             vocabulary=voc, device="cpu",
                             tracker_overrides=dict(
                                 max_kf=128, max_lm=16000,
                                 min_stereo_init_feats=150,
                                 vel_rot_damp=0.9))
        tr = sysm.tracker

        def feed(i, img_l, img_r, ts_i, acc, gyr):
            return sysm.track_stereo(torch.from_numpy(img_l),
                                     torch.from_numpy(img_r), i * 0.05,
                                     imu_batch=(ts_i, acc, gyr))[0]
    tr.pipelined = False
    rng = np.random.default_rng(2)
    states = []
    for i, (R, t) in enumerate(poses):
        c = -R.T @ t
        t_r = (-R @ (c + R.T @ np.array([b, 0, 0], np.float32))).astype(
            np.float32)
        ts_i, acc, gyr = imu_between((i - 1) * 0.05, i * 0.05, rng=rng,
                                     noise_g=2.4e-3, noise_a=2.8e-2,
                                     pose_fn=pose_fn)
        states.append(feed(i, left[i], world.render(R, t_r), ts_i, acc,
                           gyr))
    tr.flush()
    m = tr.m
    valid = np.asarray(m.kf_valid)
    kts = np.asarray(m.kf_ts)
    kR, kt = np.asarray(m.kf_R, np.float64), np.asarray(m.kf_t, np.float64)
    ks = [k for k in range(valid.shape[0]) if valid[k]]
    tilts = []
    for k in ks:
        v = (pose_fn(float(kts[k]))[0].T @ kR[k]).T @ [0, 0, 1.0]
        tilts.append(float(np.arctan2(np.hypot(v[0], v[1]), v[2])))
    C = {k: -kR[k].T @ kt[k] for k in ks}
    period = n_frames / circuits * 0.05
    gaps = [np.linalg.norm(C[a] - C[c]) for a in ks for c in ks
            if abs((kts[a] - kts[c]) - period) < 0.15]
    return dict(package=package, frames=n_frames,
                frames_ok=sum(st == "OK" for st in states),
                imu_ready=bool(tr.imu_ready), keyframes=len(ks),
                max_tilt_rad=max(tilts),
                circuit_gap=float(np.mean(gaps)) if gaps else None,
                loops_closed=int(getattr(tr, "n_loops_closed", 0)))


if __name__ == "__main__":
    import argparse
    import json
    import time
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    ap.add_argument("--frames", type=int, default=300)
    args = ap.parse_args()
    t0 = time.perf_counter()
    out = ring_circuit(args.package, args.frames)
    print(json.dumps(dict(out, seconds=time.perf_counter() - t0)))
