"""Parity of the PyTorch port's stereo / RGB-D stages with the JAX package
on the CPU (the plain versions of K3, K7 and K8), on one 384x288
PlaneWorld stereo pair (500 features, 4 levels) and the rectification
geometry of test_rectify.py.

Tolerances:
- rectifying rotations within 1e-6; rectify maps within 1e-3 px (both
  frameworks evaluate the distortion polynomials in float32, in another
  order); remap within 1e-4 on 0-255 images;
- match_stereo on the same features: on integer-valued images every SAD
  is an exact integer, so `valid` is identical, `u_right` within 1e-3 px
  and `depth` within 1e-4 relative; on non-integer images (sums in another
  order) `u_right` within 1e-3 px and at most 0.5% of `valid` flipped;
- depth_from_rgbd: `valid` and `depth` exact, `u_right` within 1e-4 px
  (XLA on the CPU divides through an approximate reciprocal, up to 1 ulp
  off the IEEE quotient the port computes);
- extract_stereo_frame / extract_rgbd_frame: the frontend's tolerances of
  test_torch_frontend.py (level-0 keypoints identical; their undistorted
  uv within 1e-4 px), and on the level-0
  slots the depth / right-u within 1e-4 relative where both found one, with
  at most 1% of them found by one side only;
- stereo_initialize and create_close_landmarks given the same map and
  frame: slots and flags exact, landmarks within 1e-5;
- stepwise stereo tracking (the JAX tracker's map and FrameData of 4
  frames fed to the port): R, t within 1e-4, >= 99% identical
  feature-landmark associations, identical decision vectors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rot

from morb_slam_tpu import cameras as j_cam
from morb_slam_tpu import frontend as j_fe
from morb_slam_tpu.mapstate import state as j_ms
from morb_slam_tpu.ops import rectify as j_rect
from morb_slam_tpu.ops import stereo as j_stereo
from morb_slam_tpu.pipeline import tracking as j_tr
from morb_slam_tpu_torch import cameras, convert, frontend
from morb_slam_tpu_torch.ops import rectify, stereo
from morb_slam_tpu_torch.pipeline import tracking

from synthetic_world import PlaneWorld, camera_path

torch.set_num_threads(1)
W, H, FX = 384, 288, 300.0
B = 0.12
K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
CFG = dict(width=W, height=H, focal=FX, n_feat=500, max_kf=48, max_lm=8000,
           n_levels=4, baseline=B, min_stereo_init_feats=200)
SF = [1.2 ** i for i in range(4)]


@pytest.fixture(scope="module")
def world():
    return PlaneWorld(K, W, H, seed=0), camera_path(8, step=0.05)


def _pair(world, i, integer=True):
    scene, poses = world
    R, t = poses[i]
    il = scene.render(R, t)
    ir = scene.render(R, t - np.asarray([B, 0, 0], np.float32))
    if integer:
        il, ir = (np.clip(x, 0, 255).astype(np.uint8).astype(np.float32)
                  for x in (il, ir))
    return il, ir


def _np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _t(a):
    return torch.from_numpy(np.array(a))


def _rig(angle=0.03):
    R_12 = Rot.from_rotvec([0.01, angle, -0.005]).as_matrix()
    T = np.eye(4)
    T[:3, :3] = R_12
    T[:3, 3] = [0.11, 0.002, -0.001]
    return T


def test_rectifying_rotations_parity():
    T = _rig()
    R_12, t_12 = T[:3, :3].astype(np.float32), T[:3, 3].astype(np.float32)
    want = j_rect.rectifying_rotations(jnp.asarray(R_12), jnp.asarray(t_12))
    got = rectify.rectifying_rotations(_t(R_12), _t(t_12))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


CAMS = {
    "pinhole-radtan": lambda m: m.pinhole(
        280.0, 280.0, 160.0, 120.0, dist=[-0.28, 0.07, 1e-4, -2e-5, 0.0]),
    "kb8": lambda m: m.kannala_brandt8(190.0, 190.0, 160.0, 120.0, 0.0034,
                                       0.0007, -0.002, 0.0003),
}


@pytest.mark.parametrize("model", sorted(CAMS))
def test_build_rectify_maps_parity(model):
    T = _rig(angle=0.02)
    focal = 160.0 if model == "kb8" else None
    want = j_rect.build_rectify_maps(CAMS[model](j_cam), CAMS[model](j_cam),
                                     T, 320, 240, focal=focal)
    got = rectify.build_rectify_maps(CAMS[model](cameras),
                                     CAMS[model](cameras), T, 320, 240,
                                     focal=focal)
    for name in ("map1", "map2"):
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.shape == b.shape == (240, 320, 2)
        assert float(np.abs(a - b).max()) < 1e-3, name
    np.testing.assert_allclose(got.R_rect1.numpy(), np.asarray(want.R_rect1),
                               atol=1e-6)
    np.testing.assert_allclose(float(got.baseline), float(want.baseline),
                               atol=1e-6)
    np.testing.assert_array_equal(got.cam_new.params.numpy(),
                                  np.asarray(want.cam_new.params))
    # the JAX maps, carried over by convert, drive the port's remap
    d = {k: np.asarray(getattr(want, k))
         for k in ("map1", "map2", "baseline", "R_rect1")}
    d["cam_new"] = (want.cam_new.kind, np.asarray(want.cam_new.params))
    back = convert.rectify_from_numpy(d)
    assert back.cam_new.kind == got.cam_new.kind
    img = np.random.default_rng(6).uniform(0, 255, (240, 320)).astype(
        np.float32)
    for name in ("map1", "map2"):
        np.testing.assert_allclose(
            rectify.remap_bilinear(_t(img), getattr(back, name)).numpy(),
            np.asarray(j_rect.remap_bilinear(jnp.asarray(img),
                                             getattr(want, name))),
            atol=1e-4)


def test_remap_parity_random_map():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (60, 80)).astype(np.float32)
    mp = np.stack([rng.uniform(-2, 81, (50, 70)),
                   rng.uniform(-2, 61, (50, 70))], -1).astype(np.float32)
    mp[0, :4] = [[79, 59], [79 + 1e-4, 0], [0, -1e-4], [0, 0]]
    want = np.asarray(j_rect.remap_bilinear(jnp.asarray(img),
                                            jnp.asarray(mp)))
    got = rectify.remap_bilinear(_t(img), _t(mp)).numpy()
    assert float(np.abs(got - want).max()) < 1e-4
    assert got[0, 1] == 0 and got[0, 2] == 0 and got[0, 0] == img[59, 79]
    batch = rectify.remap_bilinear(_t(np.stack([img, img[::-1]])),
                                   _t(np.stack([mp, mp])))
    np.testing.assert_array_equal(batch[0].numpy(), got)


def test_remap_identity_and_shift():
    """test_rectify.py's identity and half-pixel shift cases."""
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (40, 60)).astype(np.float32)
    u, v = np.meshgrid(np.arange(60, dtype=np.float32),
                       np.arange(40, dtype=np.float32))
    ident = np.stack([u, v], -1)
    for m in (ident, ident + np.asarray([0.5, 0.0], np.float32)):
        want = np.asarray(j_rect.remap_bilinear(jnp.asarray(img),
                                                jnp.asarray(m)))
        got = rectify.remap_bilinear(_t(img), _t(m)).numpy()
        assert float(np.abs(got - want).max()) < 1e-4
    np.testing.assert_allclose(rectify.remap_bilinear(_t(img), _t(ident))
                               .numpy(), img, atol=1e-3)
    shifted = rectify.remap_bilinear(_t(img), _t(ident + np.float32(
        [0.5, 0.0]))).numpy()
    np.testing.assert_allclose(shifted[:, :-1], 0.5 * (img[:, :-1]
                                                       + img[:, 1:]),
                               atol=1e-3)


@pytest.fixture(scope="module")
def features(world):
    """The JAX frontend's features of the integer and the float pair."""
    cfg = j_fe.OrbConfig(n_features=500, n_levels=4)
    ext = jax.jit(j_fe.extract_orb, static_argnames="cfg")
    out = {}
    for integer in (True, False):
        il, ir = _pair(world, 3, integer)
        out[integer] = (il, ir, _np(ext(jnp.asarray(il), cfg)),
                        _np(ext(jnp.asarray(ir), cfg)))
    return out


@pytest.mark.parametrize("integer", [True, False],
                         ids=["integer", "non-integer"])
def test_match_stereo_parity(features, integer):
    il, ir, fl, fr = features[integer]
    bf = B * FX
    match = jax.jit(j_stereo.match_stereo, static_argnames=("bf", "min_z"))
    want = _np(match(j_fe.Features(**fl), j_fe.Features(**fr),
                     jnp.asarray(il), jnp.asarray(ir),
                     jnp.asarray(SF, jnp.float32), bf=bf, min_z=B))
    got = stereo.match_stereo(convert.frame_from_numpy(fl),
                              convert.frame_from_numpy(fr), _t(il), _t(ir),
                              torch.tensor(SF, dtype=torch.float32), bf, B)
    got = {k: v.numpy() for k, v in got._asdict().items()}
    both = got["valid"] & want["valid"]
    assert both.sum() > 100, both.sum()
    flips = int((got["valid"] != want["valid"]).sum())
    if integer:
        assert flips == 0
        np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-4)
    else:
        assert flips <= 0.005 * len(got["valid"]), flips
    assert float(np.abs(got["u_right"] - want["u_right"])[both].max()) < 1e-3


def test_sad_refine_kernel_contract(features):
    """The plain K7 on keypoints at the image corners and outside: the
    reference's dynamic_slice clamping, integer SADs, offsets in range."""
    il, ir, fl, _ = features[True]
    uv = torch.tensor([[0.0, 0.0], [W - 1.0, H - 1.0], [-30.0, 5.0],
                       [W + 40.0, H + 40.0], [100.5, 50.5]])
    u0 = uv[:, 0] - 3.0
    ur, sad, k = stereo.sad_refine(_t(il), _t(ir), uv, u0)
    assert torch.all((k >= 0) & (k <= 10))
    assert torch.equal(sad, torch.round(sad))
    assert torch.all(torch.abs(ur - (u0 + k.float() - 5)) <= 1.0)


def test_depth_from_rgbd_exact(features):
    il, _, fl, _ = features[True]
    rng = np.random.default_rng(4)
    depth = rng.uniform(0.5, 6.0, (H, W)).astype(np.float32)
    depth[rng.random((H, W)) < 0.2] = 0.0
    want = _np(j_stereo.depth_from_rgbd(j_fe.Features(**fl),
                                        jnp.asarray(depth), bf=40.0))
    got = stereo.depth_from_rgbd(convert.frame_from_numpy(fl), _t(depth),
                                 40.0)
    np.testing.assert_array_equal(got.valid.numpy(), want["valid"])
    np.testing.assert_array_equal(got.depth.numpy(), want["depth"])
    np.testing.assert_allclose(got.u_right.numpy(), want["u_right"],
                               atol=1e-4, rtol=0)


def _level0(n_feat=500):
    return slice(0, frontend.OrbConfig(n_features=n_feat,
                                       n_levels=4).per_level_counts()[0])


def _check_frame(got, want):
    sl = _level0()
    # keypoints identical; uv passes through undistort_points' float math
    np.testing.assert_allclose(got["uv"][sl], want["uv"][sl], atol=1e-4)
    np.testing.assert_array_equal(got["valid"][sl], want["valid"][sl])
    np.testing.assert_allclose(got["xn"][sl], want["xn"][sl], atol=1e-6)
    gd, wd = got["depth"][sl] > 0, want["depth"][sl] > 0
    assert (gd != wd).sum() <= 0.01 * gd.size, int((gd != wd).sum())
    both = gd & wd
    assert both.sum() > 50
    np.testing.assert_allclose(got["depth"][sl][both], want["depth"][sl][both],
                               rtol=1e-4)
    np.testing.assert_allclose(got["ur"][sl][both], want["ur"][sl][both],
                               rtol=1e-4, atol=1e-6)


def test_extract_stereo_frame_parity(world):
    il, ir = _pair(world, 3)
    cam = j_cam.pinhole(FX, FX, W / 2, H / 2)
    want = _np(j_tr.extract_stereo_frame(jnp.asarray(il), jnp.asarray(ir),
                                         cam.params, cam.kind,
                                         j_tr.TrackerConfig(**CFG)))
    got = tracking.extract_stereo_frame(
        _t(il), _t(ir), cameras.pinhole(FX, FX, W / 2, H / 2),
        tracking.TrackerConfig(**CFG))
    _check_frame({k: v.numpy() for k, v in got._asdict().items()}, want)


def test_extract_rgbd_frame_parity(world):
    il, _ = _pair(world, 3)
    rng = np.random.default_rng(5)
    depth = rng.uniform(1.0, 6.0, (H, W)).astype(np.float32)
    depth[:, :40] = 0.0
    cam = j_cam.pinhole(FX, FX, W / 2, H / 2)
    want = _np(j_tr.extract_rgbd_frame(jnp.asarray(il), jnp.asarray(depth),
                                       cam.params, cam.kind,
                                       j_tr.TrackerConfig(**CFG)))
    got = tracking.extract_rgbd_frame(
        _t(il), _t(depth), cameras.pinhole(FX, FX, W / 2, H / 2),
        tracking.TrackerConfig(**CFG))
    _check_frame({k: v.numpy() for k, v in got._asdict().items()}, want)


@pytest.fixture(scope="module")
def jax_maps(world):
    """A JAX stereo-initialized map, a second keyframe inserted, and the
    close landmarks created for it, with their input FrameData."""
    cfg = j_tr.TrackerConfig(**CFG)
    cam = j_cam.pinhole(FX, FX, W / 2, H / 2)
    frames = []
    for i in (0, 3):
        il, ir = _pair(world, i)
        frames.append(j_tr.extract_stereo_frame(
            jnp.asarray(il), jnp.asarray(ir), cam.params, cam.kind, cfg))
    m0 = j_ms.empty_map(cfg.max_kf, cfg.n_feat, cfg.max_lm)
    m1, k0 = j_tr.stereo_initialize(m0, frames[0], jnp.float32(0.0), cfg)
    R, t = world[1][3]
    m2, _ = j_tr.insert_keyframe(m1, frames[1], jnp.full(500, -1, jnp.int32),
                                 jnp.asarray(R), jnp.asarray(t),
                                 jnp.float32(3.0), slot=jnp.int32(1),
                                 prev_id=jnp.int32(0))
    m3 = j_tr.create_close_landmarks(m2, jnp.int32(1), frames[1], cfg)
    return [_np(f) for f in frames], [_np(m) for m in (m0, m1, m2, m3)]


def _check_map(got, want):
    got = convert.map_to_numpy(got)
    for k, w in want.items():
        g = got[k]
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_stereo_initialize_parity(jax_maps):
    frames, maps = jax_maps
    m, k0 = tracking.stereo_initialize(
        convert.map_from_numpy(maps[0]), convert.frame_from_numpy(frames[0]),
        0.0, tracking.TrackerConfig(**CFG), slot=0)
    assert k0 == 0 and int(m.n_lm) > 200
    _check_map(m, maps[1])


def test_create_close_landmarks_parity(jax_maps):
    frames, maps = jax_maps
    m = tracking.create_close_landmarks(
        convert.map_from_numpy(maps[2]), 1,
        convert.frame_from_numpy(frames[1]), tracking.TrackerConfig(**CFG))
    assert int(m.n_lm) > int(maps[2]["n_lm"])
    _check_map(m, maps[3])


@pytest.fixture(scope="module")
def jax_steps(world):
    """The JAX tracker's per-frame inputs and outputs for the first 4
    stereo frames tracked after the first-frame initialization."""
    scene, poses = world
    tracker = j_tr.Tracker(j_cam.pinhole(FX, FX, W / 2, H / 2),
                           j_tr.TrackerConfig(**CFG))
    rec = []
    orig = j_tr.track_step_stereo

    def capture(*args, **kw):
        out = orig(*args, **kw)
        rec.append((args, out))
        return out
    j_tr.track_step_stereo = capture
    try:
        for i in range(len(poses)):
            tracker.track_stereo(*_pair(world, i, integer=False),
                                 ts=float(i))
            if len(rec) >= 4:
                break
    finally:
        j_tr.track_step_stereo = orig
    return rec


@pytest.mark.parametrize("step", range(4))
def test_stepwise_stereo_parity(jax_steps, step):
    args, out = jax_steps[step]
    m, last, last_lm, R_last, t_last, vel_R, vel_t, has_vel, ref_kf = \
        args[2:11]
    fr_j, out_j = out[0], out[1]
    fr_t, out_t, _, _, info_t = tracking.track_step_framedata(
        convert.frame_from_numpy(_np(fr_j)), convert.map_from_numpy(_np(m)),
        convert.frame_from_numpy(_np(last)), _t(last_lm), _t(R_last),
        _t(t_last), _t(vel_R), _t(vel_t), bool(has_vel), int(ref_kf),
        cameras.pinhole(FX, FX, W / 2, H / 2), tracking.TrackerConfig(**CFG))
    np.testing.assert_allclose(out_t.R.numpy(), np.asarray(out_j.R),
                               atol=1e-4)
    np.testing.assert_allclose(out_t.t.numpy(), np.asarray(out_j.t),
                               atol=1e-4)
    same = (out_t.feat_lm.numpy() == np.asarray(out_j.feat_lm)).mean()
    assert same >= 0.99, same
    assert int(out_t.ref_kf) == int(out_j.ref_kf)
    assert np.isfinite(np.asarray(fr_j.ur)).sum() > 100
    np.testing.assert_array_equal(info_t.numpy(), np.asarray(out[4]))
