"""Loop closing and the Atlas merge end to end through the PyTorch port on
the CPU (its plain kernel versions), at the JAX tests' gates:

- `LoopCloser.maybe_close` through the port's Tracker on
  tests/test_loop_closing.py's drifted-revisit map: no loop on the first
  detection, a loop on the second, the late keyframes' centre RMSE under
  0.4 x its value before, finite poses and landmarks, the body-frame
  velocities kept (cosine > 0.999) with a uniform scale, and the detached
  global BA started and finished by `flush()`;
- tests/test_atlas.py's lost-and-merge sequence (out and back over the
  plane world, a new map at the turn) through the port's Tracker: the
  stashed map merged back, > 70% of frames OK, the trajectory over both
  maps within a Sim3 ATE of 0.08 x extent;
- `System` with a vocabulary builds the loop closer with `loop_closing`
  on and has none with it off;
- a tracker with `pipelined = False` decides every frame at once, and a
  pipelined one drops its in-flight frames after an insert that closes a
  loop.

The 300-frame stereo ring circuit (tests/test_loop_closing.py's live loop
test) is too long for the CPU suite: `chip_smoke.py`'s loop phase runs it
through the port's System on the card.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from morb_slam_tpu_torch import alignment, cameras, convert, frontend, lie
from morb_slam_tpu_torch import system
from morb_slam_tpu_torch.io import config
from morb_slam_tpu_torch.pipeline import loop_closing, tracking
from morb_slam_tpu_torch.vocab import database as kfdb
from morb_slam_tpu_torch.vocab import tree

from synthetic_world import PlaneWorld, camera_path
from test_loop_closing import _drifted_revisit_map

torch.set_num_threads(1)
W, H, FX = 384, 288, 300.0
K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])


def drifted_tracker():
    """The port's tracker on the drifted-revisit map, its database filled
    with the 20 keyframes' BoW vectors (returned)."""
    m, desc, centers_true, _ = _drifted_revisit_map()
    voc = tree.train(desc, k=6, depth=3, iters=4)
    cfg = tracking.TrackerConfig(width=W, height=H, focal=FX, n_feat=256,
                                 max_kf=24, max_lm=1024, n_levels=4)
    tr = tracking.Tracker(cameras.pinhole(FX, FX, W / 2, H / 2), cfg,
                          device="cpu", voc=voc)
    tr.m = convert.map_from_numpy({k: np.asarray(v)
                                   for k, v in m._asdict().items()})
    tr.n_kf_host = 20
    bows = []
    for i in range(20):
        bow = tree.bow_vector(tr.voc, tree.transform(
            tr.voc, tr.m.kf_feat_desc[i], tr.m.kf_feat_valid[i]))
        tr.db = kfdb.add_keyframe(tr.db, i, bow)
        bows.append(bow)
    return tr, bows, centers_true


def test_loop_closes_on_drifted_revisit():
    tr, bows, centers_true = drifted_tracker()

    def center_rmse():
        c = -lie.matvec(tr.m.kf_R[10:20].transpose(-1, -2),
                        tr.m.kf_t[10:20]).numpy()
        gt = np.stack([centers_true[i] for i in range(10, 20)])
        return float(np.sqrt(np.mean(np.sum((c - gt) ** 2, axis=1))))

    before = center_rmse()
    assert before > 0.2, before
    rng = np.random.default_rng(3)
    v_w = rng.normal(0, 1.0, (tr.m.kf_v.shape[0], 3)).astype(np.float32)
    tr.m = tr.m._replace(kf_v=torch.from_numpy(v_w))
    v_body_before = lie.matvec(tr.m.kf_R, tr.m.kf_v).numpy()

    closer = loop_closing.LoopCloser(tr.cfg)
    fired = [closer.maybe_close(tr, k, bows[k]) for k in (18, 19)]
    assert not fired[0], "a loop must not fire on the first detection"
    assert fired[1], "no loop on consecutive detections"
    assert tr._gba_job is not None and tr._gba_job.left == 4
    after = center_rmse()
    print(f"\ncentre RMSE {before:.4f} -> {after:.4f}")
    assert after < 0.4 * before, (before, after)
    assert np.isfinite(tr.m.kf_t.numpy()).all()
    assert np.isfinite(tr.m.lm_pos.numpy()).all()
    v_body = lie.matvec(tr.m.kf_R, tr.m.kf_v).numpy()
    valid = tr.m.kf_valid.numpy()
    a, b = v_body[valid], v_body_before[valid]
    cos = np.sum(a * b, 1) / np.clip(np.linalg.norm(a, axis=1)
                                     * np.linalg.norm(b, axis=1), 1e-9, None)
    ratios = np.linalg.norm(a, axis=1) / np.clip(np.linalg.norm(b, axis=1),
                                                 1e-9, None)
    assert np.isfinite(v_body).all()
    assert np.all(cos > 0.999), cos.min()
    assert ratios.max() / ratios.min() < 1.2, (ratios.min(), ratios.max())
    tr.flush()
    assert tr._gba_job is None
    assert np.isfinite(tr.m.kf_t.numpy()).all()


def test_pipelined_tracker_drops_in_flight_frames_on_a_loop(monkeypatch):
    """With `pipelined` left on, the deferred decision whose keyframe insert
    closes a loop drops the in-flight frames and re-anchors (as the JAX
    tracker's `_decide_pending`); an insert without a loop keeps them and
    carries its keyframe's correction to them. The inserts are keyframes 18
    and 19 of the drifted-revisit map, so the parts of the insert that need
    a real frame (slot, map insert, BoW, local mapping) are stubbed."""
    tr, bows, _ = drifted_tracker()
    assert tr.pipelined and tr.loop_closer is not None
    slots = iter((18, 19))
    monkeypatch.setattr(tr, "_alloc_kf_slot", lambda: next(slots))
    monkeypatch.setattr(tracking, "insert_keyframe",
                        lambda m, *a, **k: (m, None))
    monkeypatch.setattr(tr, "_db_add", lambda k, fr: bows[k])
    monkeypatch.setattr(tracking.local_mapping, "mapping_step",
                        lambda m, *a: m)
    monkeypatch.setattr(tr, "_need_new_kf", lambda *a, **k: True)

    def decide(k, ts):
        tr._pending = [[None, ts + 1, None, None], [None, ts + 2, None, None]]
        tr.last = "in-flight anchor"
        out = SimpleNamespace(R=tr.m.kf_R[k].clone(), t=tr.m.kf_t[k].clone(),
                              feat_lm=tr.m.kf_feat_lm[k])
        info = torch.tensor([200.0, float(k), 1.0, 0, 500, 0, 0])
        tr._decide_pending(("frame", out, None, (out.R, out.t), info),
                           float(ts))

    decide(18, 18)
    assert tr.n_loops_closed == 0
    assert len(tr._pending) == 2 and tr.last == "frame"
    for entry in tr._pending:
        assert entry[2] is not None      # the insert's correction, carried
    decide(19, 19)
    assert tr.n_loops_closed == 1, "the second detection must close"
    assert tr._pending == [] and tr.last is None
    assert tr._gba_job is not None
    assert len(tr.trajectory) == 2
    tr.flush()
    assert tr._gba_job is None
    assert np.isfinite(tr.m.kf_t.numpy()).all()


def test_atlas_lost_and_merge_e2e():
    world = PlaneWorld(K, W, H, seed=0)
    fwd = camera_path(24, step=0.05)
    seq = fwd + fwd[-2::-1]
    ocfg = frontend.OrbConfig(n_features=300, n_levels=4)
    descs = []
    for R, t in seq[::6]:
        f = frontend.extract_orb(torch.from_numpy(world.render(R, t)), ocfg)
        descs.append(f.desc[f.valid].numpy().view(np.uint32))
    voc = tree.train(np.concatenate(descs), k=6, depth=3, iters=3)
    cfg = tracking.TrackerConfig(width=W, height=H, focal=FX, n_feat=500,
                                 max_kf=64, max_lm=8000, n_levels=4,
                                 min_init_matches=60, min_init_points=40)
    tr = tracking.Tracker(cameras.pinhole(FX, FX, W / 2, H / 2), cfg,
                          device="cpu", voc=voc)
    cut = len(fwd)
    states = []
    for i, (R, t) in enumerate(seq):
        if i == cut:
            assert tr.n_kf_host >= 3
            tr.create_map_in_atlas()
            assert len(tr.stash) == 1 and tr.state == "NOT_INITIALIZED"
        states.append(tr.track_mono(world.render(R, t), ts=float(i))[0])
    assert any(st.merged_into_gen >= 0 for st in tr.stash), \
        "the stashed map was never merged back"
    ok = sum(s == "OK" for s in states)
    assert ok > 0.7 * len(states), (ok, len(states))
    traj = tr.trajectory_world()
    assert len(traj) > 0.7 * len(seq)
    est = np.asarray([p for _, p in traj], np.float32)
    gt = np.asarray([-(seq[int(round(ts))][0].T @ seq[int(round(ts))][1])
                     for ts, _ in traj], np.float32)
    rmse, _, _, _ = alignment.ate_rmse(torch.from_numpy(est),
                                       torch.from_numpy(gt), with_scale=True)
    extent = 24 * 0.05
    print(f"\nmerge e2e: {ok}/{len(states)} OK, Sim3 ATE {float(rmse):.4f} "
          f"over {extent} m, loops + merges {tr.n_loops_closed}")
    assert float(rmse) < 0.08 * extent, (float(rmse), extent)


@pytest.mark.parametrize("loop_closing_on", [True, False])
def test_system_builds_loop_closer(loop_closing_on):
    voc = tree.train(np.random.default_rng(0).integers(
        0, 2 ** 32, (200, 8), dtype=np.uint32), k=4, depth=2, iters=2)
    settings = config.Settings(
        cam1=config.CameraSettings(fx=FX, fy=FX, cx=W / 2, cy=H / 2,
                                   width=W, height=H),
        loop_closing=loop_closing_on)
    s = system.System(settings, system.Sensor.MONOCULAR, vocabulary=voc,
                      device="cpu", tracker_overrides=dict(max_kf=8,
                                                           max_lm=500))
    assert (s.tracker.loop_closer is not None) == loop_closing_on
    assert s.tracker.db is not None
    s.reset()
    assert (s.tracker.loop_closer is not None) == loop_closing_on


def test_unpipelined_tracker_decides_every_frame():
    """`pipelined = False` (what tests/test_loop_closing.py sets on the JAX
    tracker) keeps no frame's decision pending."""
    world = PlaneWorld(K, W, H, seed=0)
    cfg = tracking.TrackerConfig(width=W, height=H, focal=FX, n_feat=500,
                                 max_kf=16, max_lm=4000, n_levels=4,
                                 min_init_matches=60, min_init_points=40)
    tr = tracking.Tracker(cameras.pinhole(FX, FX, W / 2, H / 2), cfg,
                          device="cpu")
    assert tr.pipelined
    tr.pipelined = False
    states = []
    for i, (R, t) in enumerate(camera_path(8, step=0.05)):
        states.append(tr.track_mono(world.render(R, t), ts=float(i))[0])
        assert not tr._pending, i
    assert states[-1] == "OK", states
    assert not tr._use_pipeline()
    tr.pipelined = True
    assert tr._use_pipeline()


def _ring_at_card_config(package: str, frames: int, pipelined: bool):
    """The card's loop phase on the CPU: `chip_smoke.py`'s ring world and
    EuRoC rig, rectified by the port, through the port's or the JAX
    package's tracker (the same configuration and settings, decisions
    pipelined or not), printing each loop verification, the frames'
    states and the loops closed."""
    import chip_smoke as cs
    from morb_slam_tpu_torch.ops import rectify
    cs.DEV = "cpu"
    state = {}
    world = cs.RingWorld(np.array([[cs.FX, 0, cs.W / 2], [0, cs.FX, cs.H / 2],
                                   [0, 0, 1.0]]), cs.W, cs.H, "cpu")
    poses = cs.ring_path(frames, circuits=frames / cs.LOOP_PERIOD)
    maps = cs._rig(state)["maps"]
    mm = torch.stack([maps.map1, maps.map2])
    rect = [rectify.remap_bilinear(torch.stack(
        cs._raw_pair(state, R, t, world=world)).float(), mm)
        for R, t in poses]
    params = [float(x) for x in maps.cam_new.params[:4]]
    kw = dict(width=cs.W, height=cs.H, focal=params[0], n_feat=1200,
              n_levels=8, baseline=float(maps.baseline), th_depth=60.0,
              min_stereo_init_feats=150, vel_rot_damp=0.9)
    if package == "jax":
        import jax.numpy as jnp
        from morb_slam_tpu import cameras as j_cam, frontend as j_fe
        from morb_slam_tpu.pipeline import loop_closing as lc
        from morb_slam_tpu.pipeline import tracking as trk
        from morb_slam_tpu.vocab import tree as voc_tree
        descs = [j_fe.extract_orb(jnp.asarray(a.numpy()),
                                  j_fe.OrbConfig(n_features=1200, n_levels=8))
                 for a, _ in rect[::25]]
        descs = [np.asarray(f.desc)[np.asarray(f.valid)] for f in descs]
        cam = j_cam.pinhole(*params)
        to_img = lambda x: x.numpy()
    else:
        lc, trk, voc_tree = loop_closing, tracking, tree
        descs = [frontend.extract_orb(a, frontend.OrbConfig(
            n_features=1200, n_levels=8)) for a, _ in rect[::25]]
        descs = [f.desc[f.valid].numpy().view(np.uint32) for f in descs]
        cam = cameras.pinhole(*params)
        to_img = lambda x: x
    voc = voc_tree.train(np.concatenate(descs), k=8, depth=3, iters=4)
    tr = trk.Tracker(cam, trk.TrackerConfig(**kw), voc=voc,
                     **({} if package == "jax" else dict(device="cpu")))
    tr.pipelined = pipelined
    for name in ("verify_candidate", "guided_sim3_verify"):
        def logged(*a, _fn=getattr(lc, name), _name=name, **k):
            r = _fn(*a, **k)
            print(f"  {_name} kf {int(a[1])} cand {int(a[2])}: "
                  f"{int(r[3])}", flush=True)
            return r
        setattr(lc, name, logged)
    states = ""
    for i, (a, b) in enumerate(rect):
        states += tr.track_stereo(to_img(a), to_img(b),
                                  ts=float(i) * 0.05)[0][0]
        if i % 25 == 0:
            print(f"frame {i}: {tr.n_kf_host} keyframes, "
                  f"{tr.n_loops_closed} loops, states {states}", flush=True)
    tr.flush()
    print("states:", states)
    print(f"{package}, {frames} frames: {tr.n_kf_host} keyframes, "
          f"{tr.n_loops_closed} loops closed", flush=True)


if __name__ == "__main__":
    # PYTHONPATH=.:tests python tests/test_torch_loop_e2e.py --package jax
    # --frames 300 [--pipelined]   (~10 min on the CPU)
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    ap.add_argument("--frames", type=int, default=346)
    ap.add_argument("--pipelined", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(4)
    _ring_at_card_config(args.package, args.frames, args.pipelined)
