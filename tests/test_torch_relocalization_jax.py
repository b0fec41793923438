"""The JAX tracker on the blackout sequence of test_torch_relocalization.py,
with the same vocabulary, and the port's `relocalize_candidate` stepwise
against it:

- the JAX tracker, its loop closer removed (as loopClosing: 0 does),
  recovers through its BoW branch within the same 0.15 m gate, as the
  port does;
- `relocalize_candidate` on the map, frame and candidate keyframe of the
  JAX tracker's best relocalization attempt, handed over by `convert`, with
  the JAX attempt's RANSAC sample table: R and t within 1e-4, the same
  inlier count, >= 99% identical feature-landmark associations.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morb_slam_tpu import cameras as j_cam
from morb_slam_tpu.pipeline import tracking as j_tr
from morb_slam_tpu.solvers import ransac as j_ransac
from morb_slam_tpu.vocab import tree as j_tree
from morb_slam_tpu_torch import cameras, convert
from morb_slam_tpu_torch.ops import hamming
from morb_slam_tpu_torch.pipeline import tracking
from morb_slam_tpu_torch.tensor_ops import put

from test_torch_relocalization import (CFG, FX, H, W, blackout_scene,
                                       centre_error, recovery)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_run():
    frames, descs = blackout_scene()
    voc = j_tree.train(descs, k=6, depth=3, iters=3)
    tr = j_tr.Tracker(j_cam.pinhole(FX, FX, W / 2, H / 2),
                      j_tr.TrackerConfig(**CFG), voc=voc)
    tr.loop_closer = None          # loopClosing: 0 (System.__init__)
    calls, attempts = [], []
    state = {"i": 0}
    orig_try = tr._try_relocalize

    def try_reloc(fr):
        ok = orig_try(fr)
        calls.append((state["i"], ok))
        return ok
    tr._try_relocalize = try_reloc
    orig_cand = j_tr.relocalize_candidate

    def cand(m, fr, kf_id, key, *a, **kw):
        out = orig_cand(m, fr, kf_id, key, *a, **kw)
        if state["i"] >= 26:
            attempts.append(dict(m=m, fr=fr, kf_id=int(kf_id), key=key,
                                 out=out))
        return out
    j_tr.relocalize_candidate = cand
    states = []
    try:
        for i, img in enumerate(frames):
            state["i"] = i
            states.append(tr.track_mono(jnp.asarray(img), ts=float(i))[0])
    finally:
        j_tr.relocalize_candidate = orig_cand
    return tr, states, calls, attempts


def test_jax_tracker_recovers_the_same_way(jax_run):
    tr, states, calls, _ = jax_run
    assert "RECENTLY_LOST" in states[20:26], states[18:]
    assert states[-1] == "OK" or states[-2] == "OK", states[26:]
    first, by_bow = recovery(states, calls)
    assert by_bow, (first, calls)
    kf_ts = np.asarray(tr.m.kf_ts)[:int(tr.m.n_kf)]
    err = centre_error(tr.R_last, tr.t_last, kf_ts, tr.m.kf_R, tr.m.kf_t)
    print(f"\nJAX tracker relocalized on frame {first}, centre error "
          f"{err:.4f} m")
    assert err < 0.15, err


def test_relocalize_candidate_stepwise(jax_run):
    _, _, _, attempts = jax_run
    # the revisit attempt with the most inliers
    a = max(attempts, key=lambda a: int(a["out"][3]))
    m = convert.map_from_numpy({k: np.asarray(v)
                                for k, v in a["m"]._asdict().items()})
    fr = convert.frame_from_numpy({k: np.asarray(v)
                                   for k, v in a["fr"]._asdict().items()})
    kf = a["kf_id"]
    # the JAX attempt's sample table: its key over the same correspondence
    # mask (the port's first stage is exact, so the masks agree)
    ref_lm = m.kf_feat_lm[kf]
    ref_ok = m.kf_feat_valid[kf] & (ref_lm >= 0) & \
        m.lm_valid[torch.clamp(ref_lm, min=0).long()]
    idx, _ = hamming.match_nn(m.kf_feat_desc[kf], fr.desc,
                              ref_ok[:, None] & fr.valid[None, :], ref_ok,
                              fr.valid, max_dist=hamming.TH_LOW, ratio=0.75)
    F = fr.uv.shape[0]
    cur = put(torch.full((F,), -1, dtype=torch.int32),
              torch.where(idx >= 0, idx, torch.full_like(idx, F)), ref_lm)
    has = (cur >= 0) & m.lm_valid[torch.clamp(cur, min=0).long()]
    table = j_ransac.sample_indices(a["key"], 192, 8, F,
                                    jnp.asarray(has.numpy()))
    R, t, lm, n = tracking.relocalize_candidate(
        m, fr, kf, tracking.TrackerConfig(**CFG),
        cameras.pinhole(FX, FX, W / 2, H / 2),
        samples=torch.from_numpy(np.array(table)))
    Rj, tj, lmj, nj = (np.asarray(v) for v in a["out"])
    print(f"\nstepwise candidate {kf}: {int(n)} inliers (JAX {int(nj)})")
    assert int(nj) >= 30
    np.testing.assert_allclose(R.numpy(), Rj, atol=1e-4)
    np.testing.assert_allclose(t.numpy(), tj, atol=1e-4)
    assert int(n) == int(nj)
    assert (lm.numpy() == lmj).mean() >= 0.99


