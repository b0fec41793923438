"""BoW relocalization through the PyTorch port on the CPU (its plain K5, K9
and K10 versions):

- `solve_pnp` against the JAX package on its RANSAC sample table: R and t
  within 1e-4, the same inlier count and mask;
- the tests/test_relocalization.py blackout sequence (20 frames mapped, 6
  blank frames, a revisit of poses 12-17) through the port's System with a
  vocabulary file and loopClosing off, at that test's gates: lost in the
  blackout, OK again at the end, the relocalized camera centre within
  0.15 m of the mapped keyframe nearest the revisited pose. The recovery
  must come from the BoW branch (`_try_relocalize`). The JAX tracker on the
  same sequence is in test_torch_relocalization_jax.py;
- a System with a vocabulary relocalizes only with loopClosing off, and
  closes loops too with it on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morb_slam_tpu.solvers import pnp as j_pnp
from morb_slam_tpu.solvers import ransac as j_ransac
from morb_slam_tpu_torch import frontend, system
from morb_slam_tpu_torch.io import config, serialization
from morb_slam_tpu_torch.solvers import pnp
from morb_slam_tpu_torch.vocab import tree

from synthetic_world import PlaneWorld, camera_path

torch.set_num_threads(1)
W, H, FX = 384, 288, 300.0
K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
CFG = dict(width=W, height=H, focal=FX, n_feat=500, max_kf=48, max_lm=6000,
           n_levels=4, min_init_matches=60, min_init_points=40)


# ---------------------------------------------------------------------------
# PnP
# ---------------------------------------------------------------------------

def _pnp_case(seed, n=300, outliers=0.3, noise_px=0.5):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(3, 7, n)], -1)
    w = rng.normal(0, 0.15, 3)
    th = np.linalg.norm(w)
    Kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    R = np.eye(3) + np.sin(th) / th * Kx + (1 - np.cos(th)) / th ** 2 * Kx @ Kx
    t = rng.normal(0, 0.3, 3)
    Xc = X @ R.T + t
    x = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, noise_px / FX, (n, 2))
    bad = rng.random(n) < outliers
    x[bad] += rng.uniform(-0.3, 0.3, (int(bad.sum()), 2))
    valid = rng.random(n) < 0.9
    return (X.astype(np.float32), x.astype(np.float32), valid, R, t)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_pnp_parity(seed):
    X, x, valid, R_gt, t_gt = _pnp_case(seed)
    key = jax.random.PRNGKey(seed)
    j = j_pnp.solve_pnp(key, jnp.asarray(X), jnp.asarray(x),
                        jnp.asarray(valid), focal=FX, n_hyp=192)
    table = j_ransac.sample_indices(key, 192, 8, X.shape[0],
                                    jnp.asarray(valid))
    t = pnp.solve_pnp(torch.from_numpy(X), torch.from_numpy(x),
                      torch.from_numpy(valid), focal=FX,
                      samples=torch.from_numpy(np.array(table)), n_hyp=192)
    np.testing.assert_allclose(t.R.numpy(), np.asarray(j.R), atol=1e-4)
    np.testing.assert_allclose(t.t.numpy(), np.asarray(j.t), atol=1e-4)
    assert int(t.n_inliers) == int(j.n_inliers)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    np.testing.assert_allclose(t.R.numpy(), R_gt, atol=2e-3)
    assert int(t.n_inliers) > 0.5 * valid.sum()


# ---------------------------------------------------------------------------
# the blackout sequence
# ---------------------------------------------------------------------------

def blackout_scene():
    """The blackout sequence's frames and a k = 6, depth = 3 vocabulary
    trained, as the JAX test does, on descriptors of every 4th pose of the
    path (extracted by the port; `train` gives both packages the same
    tree from them)."""
    world = PlaneWorld(K, W, H, seed=0)
    path = camera_path(30, step=0.05)
    poses = [path[i] for i in range(20)] + [None] * 6 + \
        [path[i] for i in range(12, 18)]
    frames = [world.render(*p) if p is not None
              else np.zeros((H, W), np.float32) for p in poses]
    ocfg = frontend.OrbConfig(n_features=300, n_levels=4)
    descs = []
    for R, t in path[::4]:
        f = frontend.extract_orb(torch.from_numpy(world.render(R, t)), ocfg)
        descs.append(f.desc[f.valid].numpy().view(np.uint32))
    return frames, np.concatenate(descs)


@pytest.fixture(scope="module")
def scene():
    frames, descs = blackout_scene()
    return frames, tree.train(descs, k=6, depth=3, iters=3)


def recovery(states, reloc_calls):
    """(frame of the first OK after the blackout, whether BoW relocalization
    succeeded on that frame)."""
    first = next(i for i in range(26, len(states)) if states[i] == "OK")
    return first, (first, True) in reloc_calls


def centre_error(R, t, kf_ts, kf_R, kf_t):
    c_est = -(np.asarray(R).T @ np.asarray(t))
    k = int(np.argmin(np.abs(kf_ts - 17.0)))
    c_kf = -(np.asarray(kf_R[k]).T @ np.asarray(kf_t[k]))
    return float(np.linalg.norm(c_est - c_kf))


@pytest.fixture(scope="module")
def port_run(scene, tmp_path_factory):
    frames, voc = scene
    path = str(tmp_path_factory.mktemp("voc") / "voc.npz")
    serialization.save_vocabulary(path, voc)
    settings = config.Settings(cam1=config.CameraSettings(
        fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H),
        n_features=500, n_levels=4, loop_closing=False)
    sysm = system.System(settings, system.Sensor.MONOCULAR,
                         vocabulary_path=path, device="cpu",
                         tracker_overrides=dict(
                             max_kf=48, max_lm=6000, min_init_matches=60,
                             min_init_points=40))
    tr = sysm.tracker
    calls = []
    state = {"i": 0}
    orig_try = tr._try_relocalize

    def try_reloc(fr):
        ok = orig_try(fr)
        calls.append((state["i"], ok))
        return ok
    tr._try_relocalize = try_reloc
    states = []
    for i, img in enumerate(frames):
        state["i"] = i
        states.append(sysm.track_monocular(img, ts=float(i))[0])
    return sysm, states, calls


def test_port_relocalizes_through_bow(port_run):
    sysm, states, calls = port_run
    tr = sysm.tracker
    assert tr.db is not None and tr.loop_closer is None
    assert int(tr.db.valid.sum()) >= 3
    assert "RECENTLY_LOST" in states[20:26], states[18:]
    assert states[-1] == "OK" or states[-2] == "OK", states[26:]
    first, by_bow = recovery(states, calls)
    assert by_bow, (first, calls)
    kf_ts = tr.m.kf_ts.numpy()[:int(tr.m.n_kf)]
    err = centre_error(tr.R_last.numpy(), tr.t_last.numpy(), kf_ts,
                        tr.m.kf_R.numpy(), tr.m.kf_t.numpy())
    print(f"\nport relocalized on frame {first}, centre error {err:.4f} m")
    assert err < 0.15, err


def test_system_with_vocabulary_needs_loop_closing_off(scene):
    """Relocalization alone needs loopClosing: 0; with loop closing on (the
    default) the System's tracker closes loops too."""
    voc = scene[1]
    settings = config.Settings(cam1=config.CameraSettings(
        fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H))
    s = system.System(settings, system.Sensor.MONOCULAR, vocabulary=voc,
                      device="cpu", tracker_overrides=dict(max_kf=8,
                                                           max_lm=500))
    assert s.tracker.loop_closer is not None
    settings.loop_closing = False
    s = system.System(settings, system.Sensor.MONOCULAR, vocabulary=voc,
                      device="cpu", tracker_overrides=dict(max_kf=8,
                                                           max_lm=500))
    assert s.tracker.db.bow.shape == (8, voc.n_words)
    assert s.tracker.loop_closer is None
    s.reset()
    assert s.tracker.voc is not None and s.tracker.db is not None
    assert s.tracker.loop_closer is None
