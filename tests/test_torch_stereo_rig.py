"""The non-rectified KB8 two-camera rig of the PyTorch port against the JAX
package on the CPU (plain kernel versions), on raw 384x288 pairs of
`kb8_rig.Rig` (500 features, 4 levels):

- the KB8 camera functions (`unproject_bearing`, `undistort_points`,
  `project_distorted`) for both cameras' parameters, within 1e-5;
- `match_stereo_general_plain` against JAX's `match_stereo_general` on the
  same features, bearings and pixels of two pairs: the valid flags equal
  except rows that `testing.general_margins` names (a matchable pair within
  1e-5 of the epipolar gate, or a chi2 within 1e-5 of its gate), the
  matched right x exact, and the depth within 1e-4 relative where the
  midpoint system allows it: the two packages round the 2 x 2 normal
  equations, whose determinant is 1 - cos^2(parallax), in another order, so
  the depth differs by up to ~eps / (1 - cos parallax) (measured: relative
  gap x (1 - cos) <= 1.2e-7, float32's eps, on these pairs); the tolerance
  is max(1e-4, 4 eps / (1 - cos parallax));
- `extract_stereo_general_frame` against JAX's (keypoints, xn, ur = NaN,
  depth by the same rule);
- the rig's stereo initialization in both packages' Tracker: the same
  landmark count.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morb_slam_tpu import cameras as j_cam
from morb_slam_tpu import frontend as j_fe
from morb_slam_tpu.ops import stereo as j_stereo
from morb_slam_tpu.pipeline import tracking as j_tracking
from morb_slam_tpu_torch import cameras, frontend, testing
from morb_slam_tpu_torch.ops import stereo
from morb_slam_tpu_torch.pipeline import tracking

from kb8_rig import CAM0, CAM1, H, W, Rig, jax_rig, port_rig
from synthetic_world import camera_path

torch.set_num_threads(1)
F32_EPS = float(np.finfo(np.float32).eps)
KW = dict(width=W, height=H, focal=CAM0[0], n_feat=500, n_levels=4,
          baseline=0.10, min_stereo_init_feats=100, max_kf=16, max_lm=4000)


@pytest.fixture(scope="module")
def pairs():
    rig = Rig()
    poses = camera_path(40, step=0.025)
    return [rig.pair(*poses[i]) for i in (0, 20)]


@pytest.fixture(scope="module")
def matched(pairs):
    """JAX's match and the port's inputs of each pair."""
    return [_match_inputs(*p) for p in pairs]


def _t(x):
    return torch.from_numpy(np.array(np.asarray(x)))


def _depth_close(got, want, cosp, mask):
    tol = np.maximum(1e-4, 4 * F32_EPS / np.maximum(1 - cosp, 1e-12))
    rel = np.abs(got - want) / np.abs(want)
    assert np.all(rel[mask] <= tol[mask]), float((rel / tol)[mask].max())


def _cos_parallax(bear_l, bear_r, idx, R_rl):
    b = bear_r[torch.clamp(idx, min=0).long()]
    d2 = b @ R_rl          # R_rl^T b_r, row-wise
    return torch.sum(bear_l * d2, dim=-1).numpy()


@pytest.mark.parametrize("cam", [CAM0, CAM1])
def test_kb8_camera_functions_match_reference(cam):
    rng = np.random.default_rng(0)
    uv = np.stack([rng.uniform(0, W, 400), rng.uniform(0, H, 400)],
                  -1).astype(np.float32)
    X = rng.uniform([-3, -2, 0.2], [3, 2, 6], (400, 3)).astype(np.float32)
    tc, jc = cameras.kannala_brandt8(*cam), j_cam.kannala_brandt8(*cam)
    for name, a, b in (
            ("bearing", cameras.unproject_bearing(tc, _t(uv)),
             j_cam.unproject_bearing(jc, jnp.asarray(uv))),
            ("undistort", cameras.undistort_points(tc, _t(uv)),
             j_cam.undistort_points(jc, jnp.asarray(uv))),
            ("project", cameras.project_distorted(tc, _t(X)),
             j_cam.project_distorted(jc, jnp.asarray(X)))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=1e-5 * max(1.0, float(np.abs(
                                       np.asarray(b)).max())), err_msg=name)


def _match_inputs(img_l, img_r):
    orb = j_fe.OrbConfig(n_features=500, n_levels=4)
    fl = j_fe.extract_orb(jnp.asarray(img_l, jnp.float32), orb)
    fr = j_fe.extract_orb(jnp.asarray(img_r, jnp.float32), orb)
    jcam, (jcam2, jR, jt) = jax_rig()
    bl = j_cam.unproject_bearing(jcam, fl.uv)
    br = j_cam.unproject_bearing(jcam2, fr.uv)
    s2 = 1.2 ** (2.0 * fl.octave.astype(jnp.float32))
    jm = j_stereo.match_stereo_general(
        fl, fr, bl, br, fl.uv, fr.uv,
        lambda X: j_cam.project_distorted(jcam, X),
        lambda X: j_cam.project_distorted(jcam2, X), jR, jt, s2)
    cam, (cam2, R, t) = port_rig()
    tf = [frontend.Features(*(_t(getattr(f, k)) for k in f._fields))
          for f in (fl, fr)]
    args = (tf[0], tf[1], _t(bl), _t(br), _t(fl.uv), _t(fr.uv), cam, cam2,
            R, t, _t(s2))
    return jm, args


@pytest.mark.parametrize("k", [0, 1])
def test_match_stereo_general_plain_matches_reference(matched, k):
    jm, args = matched[k]
    sm, idx = stereo.match_stereo_general_plain(*args)
    jv = np.asarray(jm.valid)
    tv = sm.valid.numpy()
    exempt = testing.general_margins(*args, idx, idx).numpy()
    assert np.all((jv == tv) | exempt), int(((jv != tv) & ~exempt).sum())
    assert exempt.sum() <= 0.05 * len(tv) and tv.sum() > 150, (exempt.sum(),
                                                               tv.sum())
    both = jv & tv
    np.testing.assert_array_equal(sm.u_right.numpy()[both],
                                  np.asarray(jm.u_right)[both])
    _depth_close(sm.depth.numpy(), np.asarray(jm.depth),
                 _cos_parallax(args[2], args[3], idx, args[8]), both)
    assert np.all(sm.depth.numpy()[~tv] == -1)


def test_extract_stereo_general_frame_matches_reference(pairs, matched):
    img_l, img_r = pairs[0]
    jcam, (jcam2, jR, jt) = jax_rig()
    j = j_tracking.extract_stereo_general_frame(
        jnp.asarray(img_l), jnp.asarray(img_r), jcam.params, jcam.kind,
        jcam2.params, jcam2.kind, jR, jt, j_tracking.TrackerConfig(**KW))
    cam, rig = port_rig()
    t = tracking.extract_stereo_general_frame(
        _t(img_l), _t(img_r), cam, *rig, tracking.TrackerConfig(**KW))
    valid = np.asarray(j.valid)
    np.testing.assert_array_equal(t.valid.numpy(), valid)
    np.testing.assert_array_equal(t.octave.numpy(), np.asarray(j.octave))
    np.testing.assert_allclose(t.uv.numpy(), np.asarray(j.uv), atol=1e-3)
    np.testing.assert_allclose(t.xn.numpy()[valid], np.asarray(j.xn)[valid],
                               atol=1e-4)
    assert torch.isnan(t.ur).all() and np.isnan(np.asarray(j.ur)).all()
    jd, td = np.asarray(j.depth), t.depth.numpy()
    np.testing.assert_array_equal(td > 0, jd > 0)
    # the frame's depth is the match's: the same rule, its parallax from
    # the port's own match on the frame's features
    _, args = matched[0]
    _, idx = stereo.match_stereo_general_plain(*args)
    _depth_close(td, jd, _cos_parallax(args[2], args[3], idx, args[8]),
                 (td > 0) & (jd > 0))


def test_rig_initialization_landmarks_match_reference(pairs):
    img_l, img_r = pairs[0]
    jcam, jrig = jax_rig()
    jt = j_tracking.Tracker(jcam, j_tracking.TrackerConfig(**KW),
                            stereo_rig=jrig)
    cam, rig = port_rig()
    tt = tracking.Tracker(cam, tracking.TrackerConfig(**KW), device="cpu",
                          stereo_rig=rig)
    js, _ = jt.track_stereo(jnp.asarray(img_l), jnp.asarray(img_r), 0.0)
    ts, pose = tt.track_stereo(_t(img_l), _t(img_r), 0.0)
    assert js == ts == "OK" and pose is not None
    n_j = int(jnp.sum(jt.m.lm_valid))
    n_t = int(tt.m.lm_valid.sum())
    assert n_t == n_j >= KW["min_stereo_init_feats"], (n_t, n_j)
