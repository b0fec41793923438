"""Parity of the PyTorch port's loop closer with the JAX package on the
CPU (plain kernel versions), on the same inputs:

- `verify_candidate` (on JAX's RANSAC sample table; the K3 matches equal
  JAX's), `guided_sim3_verify` (s, R, t within 1e-4, the same match
  count), `correct_loop` (pose-graph costs within 1e-3 relative, poses,
  landmarks and velocities within 1e-4) and `search_and_fuse` (the same
  associations and descriptors) step by step on tests/test_loop_closing.py's
  drifted-revisit map, built once per module;
- one tie case for each top_k site of loop closing: the 16 covisibility
  edges per keyframe (a map where every weight ties, then correct_loop on
  it), the SearchAndFuse landmark pool (top_k over a boolean mask) and the
  6-newest timestamp threshold.

The solvers under it (Sim3 RANSAC, pose graph, PCG bundle adjustment,
global BA, atlas) are in test_torch_loop.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morb_slam_tpu import cameras as j_cam
from morb_slam_tpu import lie as j_lie
from morb_slam_tpu import matching as j_matching
from morb_slam_tpu.mapstate import state as j_ms
from morb_slam_tpu.ops import hamming as j_ham
from morb_slam_tpu.pipeline import loop_closing as j_lc
from morb_slam_tpu.pipeline import tracking as j_tr
from morb_slam_tpu.solvers import ransac as j_ransac
from morb_slam_tpu_torch import cameras, convert
from morb_slam_tpu_torch.mapstate import state as ms
from morb_slam_tpu_torch.ops import hamming
from morb_slam_tpu_torch.pipeline import loop_closing, tracking
from morb_slam_tpu_torch.tensor_ops import mask_first, topk

from test_loop_closing import _drifted_revisit_map
from test_torch_loop import FX, H, W, _close_rel, _jmap, _np, _t

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# loop closing, step by step on the drifted-revisit map
# ---------------------------------------------------------------------------

KF_ID, CAND = 19, 1


@pytest.fixture(scope="module")
def drifted():
    m, _, _, _ = _drifted_revisit_map()
    kw = dict(width=W, height=H, focal=FX, n_feat=256, max_kf=24,
              max_lm=1024, n_levels=4)
    return dict(jm=m, tm=convert.map_from_numpy(_jmap(m)),
                jcfg=j_tr.TrackerConfig(**kw),
                tcfg=tracking.TrackerConfig(**kw))


@pytest.fixture(scope="module")
def verified(drifted):
    """verify_candidate on JAX's sample table, then guided_sim3_verify,
    in both packages."""
    jm, tm = drifted["jm"], drifted["tm"]
    key = jax.random.PRNGKey(11)
    js, jR, jt, jn = j_lc.verify_candidate(jm, jnp.asarray(KF_ID),
                                           jnp.asarray(CAND), key,
                                           drifted["jcfg"])
    # the port's matches, checked against JAX's, fix the sample table
    lm1, ok1 = loop_closing._kf_landmarks(tm, KF_ID)
    lm2, ok2 = loop_closing._kf_landmarks(tm, CAND)
    idx, _ = hamming.match_nn(tm.kf_feat_desc[KF_ID], tm.kf_feat_desc[CAND],
                              ok1[:, None] & ok2[None, :], ok1, ok2,
                              max_dist=hamming.TH_LOW, ratio=0.75)
    j_ok1 = _np(jm.kf_feat_lm[KF_ID] >= 0) & _np(jm.kf_feat_valid[KF_ID])
    j_ok2 = _np(jm.kf_feat_lm[CAND] >= 0) & _np(jm.kf_feat_valid[CAND])
    dmat = jnp.where(jnp.asarray(j_ok1[:, None] & j_ok2[None, :]),
                     j_ham.hamming_matrix(jm.kf_feat_desc[KF_ID],
                                          jm.kf_feat_desc[CAND]), j_matching.BIG)
    j_idx, _ = j_ham.match_nn(dmat, jnp.asarray(j_ok1), jnp.asarray(j_ok2),
                              max_dist=j_ham.TH_LOW, ratio=0.75)
    np.testing.assert_array_equal(idx.numpy(), _np(j_idx))
    table = j_ransac.sample_indices(key, 128, 3, idx.shape[0],
                                    jnp.asarray(_np(j_idx) >= 0))
    ts, tR, tt, tn = loop_closing.verify_candidate(
        tm, KF_ID, CAND, drifted["tcfg"], samples=_t(table))
    g_j = j_lc.guided_sim3_verify(jm, jnp.asarray(KF_ID), jnp.asarray(CAND),
                                  js, jR, jt, key, drifted["jcfg"])
    g_t = loop_closing.guided_sim3_verify(tm, KF_ID, CAND, ts, tR, tt,
                                          drifted["tcfg"])
    return (ts, tR, tt, tn), (js, jR, jt, jn), g_t, g_j


def test_verify_candidate_parity(verified):
    (ts, tR, tt, tn), (js, jR, jt, jn), _, _ = verified
    assert int(tn) == int(jn) >= loop_closing.MIN_SIM3_INLIERS
    for a, b in ((ts, js), (tR, jR), (tt, jt)):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-4)


def test_guided_sim3_verify_parity(verified):
    _, _, (s, R, t, n), (js, jR, jt, jn) = verified
    assert int(n) == int(jn) >= loop_closing.MIN_ACCEPT_MATCHES
    for a, b in ((s, js), (R, jR), (t, jt)):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-4)


def test_correct_loop_and_search_and_fuse_parity(drifted, verified):
    jm, tm = drifted["jm"], drifted["tm"]
    _, _, (s, R, t, _), (js, jR, jt, _) = verified
    jc, jcost = j_lc.correct_loop(jm, jnp.asarray(KF_ID), jnp.asarray(CAND),
                                  js, jR, jt)
    tc, tcost = loop_closing.correct_loop(tm, KF_ID, CAND, _t(js), _t(jR),
                                          _t(jt))
    _close_rel(tcost.numpy(), _np(jcost), 1e-3)
    for f in ("kf_R", "kf_t", "lm_pos", "kf_v"):
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   _np(getattr(jc, f)), atol=1e-4,
                                   err_msg=f)
    # SearchAndFuse on the JAX-corrected map, its landmark normals and
    # scale bands refreshed (the built map's placeholders fail every
    # viewing-angle test), in both packages
    jc = j_ms.update_landmark_stats(jc)
    jcam = j_cam.pinhole(FX, FX, W / 2, H / 2)
    jf = j_lc.search_and_fuse(jc, jnp.asarray(KF_ID), jnp.asarray(CAND),
                              jcam.params, jcam.kind, drifted["jcfg"])
    tf = loop_closing.search_and_fuse(
        convert.map_from_numpy(_jmap(jc)), KF_ID, CAND,
        cameras.pinhole(FX, FX, W / 2, H / 2), drifted["tcfg"])
    fused = _np(jf.kf_feat_lm) != _np(jc.kf_feat_lm)
    assert fused.sum() > 50, fused.sum()
    np.testing.assert_array_equal(tf.kf_feat_lm.numpy(), _np(jf.kf_feat_lm))
    np.testing.assert_array_equal(tf.lm_desc.numpy().view(np.uint32),
                                  _np(jf.lm_desc))
    np.testing.assert_allclose(tf.lm_normal.numpy(), _np(jf.lm_normal),
                               atol=1e-5)


# ---------------------------------------------------------------------------
# top_k ties
# ---------------------------------------------------------------------------

def _tied_map(n_kf=20, n_lm=60):
    """Every keyframe observes the same 40 landmarks: all covisibility
    weights tie at 40, the newest keyframes' timestamps tie too. (The
    drifted map's capacities, so JAX reuses its compiled correct_loop.)"""
    m = j_ms.empty_map(24, 256, 1024)
    rng = np.random.default_rng(2)
    X = np.stack([rng.uniform(-1, 1, n_lm), rng.uniform(-1, 1, n_lm),
                  rng.uniform(4, 6, n_lm)], 1).astype(np.float32)
    d = {k: np.asarray(v).copy() for k, v in m._asdict().items()}
    for k in range(n_kf):
        d["kf_t"][k] = [-0.1 * k, 0.01 * k * k / n_kf, 0.0]
        d["kf_valid"][k] = True
        d["kf_ts"][k] = float(min(k, 16))
        d["kf_prev"][k] = k - 1
        d["kf_feat_lm"][k, :40] = np.arange(40)
        d["kf_feat_valid"][k, :40] = True
        Xc = X[:40] + d["kf_t"][k]
        d["kf_feat_xn"][k, :40] = Xc[:, :2] / Xc[:, 2:]
    d["lm_pos"][:n_lm] = X
    d["lm_valid"][:n_lm] = True
    d["lm_ref_kf"][:n_lm] = 0
    d["n_kf"], d["n_lm"] = np.asarray(n_kf), np.asarray(n_lm)
    return j_ms.MapState(**{k: jnp.asarray(v) for k, v in d.items()}), d


def test_covisibility_edge_ties():
    """correct_loop's top-16 covisible neighbours of each keyframe, 19 tied
    candidates each: the lowest slots win in both packages, and the
    corrected poses agree."""
    jm, d = _tied_map()
    tm = convert.map_from_numpy(d)
    Wj = j_ms.covisibility_matrix(jm)
    Wt = ms.covisibility_matrix(tm)
    assert int((Wt == 40).sum()) == 20 * 19
    jv, jidx = jax.lax.top_k(Wj, loop_closing.COVIS_EDGES_PER_KF)
    tv, tidx = topk(Wt, loop_closing.COVIS_EDGES_PER_KF)
    np.testing.assert_array_equal(tidx.numpy(), _np(jidx))
    R = j_lie.so3_exp(jnp.asarray([0.0, 0.02, 0.0], jnp.float32))
    tl = jnp.asarray([0.05, 0.0, 0.0], jnp.float32)
    one = jnp.asarray(1.0, jnp.float32)
    jc, _ = j_lc.correct_loop(jm, jnp.asarray(19), jnp.asarray(2), one, R,
                              tl)
    tc, _ = loop_closing.correct_loop(tm, 19, 2, _t(one), _t(R), _t(tl))
    for f in ("kf_R", "kf_t"):
        np.testing.assert_allclose(getattr(tc, f).numpy(),
                                   _np(getattr(jc, f)), atol=1e-4)


def test_fuse_pool_ties():
    """SearchAndFuse's pool is top_k over a boolean mask (every entry
    ties): the True slots in index order, then the False ones."""
    mask = np.random.default_rng(6).random(1024) < 0.3
    n = 512
    _, jidx = jax.lax.top_k(jnp.asarray(mask).astype(jnp.int32), n)
    np.testing.assert_array_equal(mask_first(_t(mask), n).numpy(),
                                  _np(jidx))


def test_newest_timestamp_threshold_ties():
    """maybe_close's exclusion threshold: the 6th newest valid timestamp,
    with ties among the newest and invalid slots at -inf."""
    _, d = _tied_map()
    ts = np.where(d["kf_valid"], d["kf_ts"], -np.inf).astype(np.float32)
    jv, jidx = jax.lax.top_k(jnp.asarray(ts), 6)
    tv, tidx = topk(_t(ts), 6)
    assert float(tv[-1]) == float(jv[-1]) == 14.0
    np.testing.assert_array_equal(tidx.numpy(), _np(jidx))
