"""Parity of the PyTorch port's loop-closing slice with the JAX package on
the CPU (plain kernel versions), on the same numpy-seeded inputs:

- `solve_sim3` on JAX's RANSAC sample table: s, R, t within 1e-4, the same
  inlier count and mask, with and without `fix_scale`;
- `pose_graph.optimize` on tests/test_pose_graph.py's drifted circle
  (Sim3, and `fix_scale`) and tests/test_global_ba.py's yaw-drift ring
  (`four_dof`): poses within 1e-4; the 7 x 14 edge Jacobian at zero
  tangent finite and within 1e-5 of `jax.jacfwd`'s (a pure-translation
  edge among them); K15's plain version `normal_equations_plain` against
  H, b and the cost assembled in numpy (float64) from JAX's
  `_edge_residual` and `jax.jacfwd`, camera side and world side: H within
  1e-5 under Jacobi scaling (|dH_ij| / sqrt(H_ii H_jj)), b within 1e-5 of
  its scaled max-abs, the cost within 1e-5 relative;
- `ba_solve_pcg` on tests/test_global_ba.py's `_synthetic_problem`: the
  per-iteration costs within 1e-3 relative; the same accept sequence over
  the first four iterations (after them the cost sits at its float32 noise
  floor, ~1e-5 relative, where accepting or not is a coin toss in either
  package); two carry-resumed slices equal to one call; the implicit
  Schur product (K14's plain passes) within 1e-5 of the reference's
  S_matvec on the same blocks; K4's per-observation blocks against
  `_assemble_blocks`;
- `global_bundle_adjustment` (the first cost, the gate's 20x decrease,
  rotations within 1e-5, camera centres within 1e-4 after a Sim3 alignment,
  the same detached outliers) and `gba_reconcile` (within 1e-5) on
  test_global_ba.py's perturbed map;
- `transform_map`, `merge_maps` and `sim3_from_cam_pair` on
  tests/test_atlas.py's inputs, and a StashedMap carried from the JAX
  package to the port and back.

The loop closer's steps and the top_k tie cases are in
test_torch_loop_closing.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from morb_slam_tpu import lie as j_lie
from morb_slam_tpu.mapstate import atlas as j_atlas
from morb_slam_tpu.mapstate import state as j_ms
from morb_slam_tpu.optim import ba as j_ba
from morb_slam_tpu.optim import pose_graph as j_pg
from morb_slam_tpu.pipeline import global_ba as j_gba
from morb_slam_tpu.pipeline import local_mapping as j_lmap
from morb_slam_tpu.solvers import ransac as j_ransac
from morb_slam_tpu.solvers import sim3 as j_sim3
from morb_slam_tpu_torch import alignment, convert, lie
from morb_slam_tpu_torch.mapstate import atlas
from morb_slam_tpu_torch.optim import ba, pose_graph
from morb_slam_tpu_torch.pipeline import global_ba, local_mapping
from morb_slam_tpu_torch.solvers import sim3

from test_global_ba import _ring_graph, _synthetic_problem
from test_pose_graph import build_drifty_graph

torch.set_num_threads(1)
W, H, FX = 384, 288, 300.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


def _jmap(m):
    return {k: np.asarray(v) for k, v in m._asdict().items()}


def _close_rel(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30)
    assert err <= tol, err


# ---------------------------------------------------------------------------
# Sim(3) RANSAC
# ---------------------------------------------------------------------------

def _sim3_case(seed, n=200, outliers=0.3, fix=False):
    rng = np.random.default_rng(seed)
    X2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(3, 7, n)], -1).astype(np.float32)
    s = 1.0 if fix else 1.15
    R = np.asarray(j_lie.so3_exp(jnp.asarray(rng.normal(0, 0.1, 3),
                                             jnp.float32)))
    t = rng.normal(0, 0.2, 3).astype(np.float32)
    X1 = (s * X2 @ R.T + t).astype(np.float32)
    x1 = X1[:, :2] / X1[:, 2:] + rng.normal(0, 0.5 / FX, (n, 2))
    x2 = X2[:, :2] / X2[:, 2:] + rng.normal(0, 0.5 / FX, (n, 2))
    bad = rng.random(n) < outliers
    X1[bad] += rng.uniform(-1, 1, (int(bad.sum()), 3))
    valid = rng.random(n) < 0.9
    return X1, X2, x1.astype(np.float32), x2.astype(np.float32), valid


@pytest.mark.parametrize("seed,fix", [(0, False), (1, True), (2, False)])
def test_solve_sim3_parity(seed, fix):
    X1, X2, x1, x2, valid = _sim3_case(seed, fix=fix)
    key = jax.random.PRNGKey(seed)
    j = j_sim3.solve_sim3(key, *(jnp.asarray(a) for a in (X1, X2, x1, x2,
                                                         valid)),
                          focal=FX, fix_scale=fix)
    table = j_ransac.sample_indices(key, 128, 3, X1.shape[0],
                                    jnp.asarray(valid))
    t = sim3.solve_sim3(*(_t(a) for a in (X1, X2, x1, x2, valid)), focal=FX,
                        fix_scale=fix, samples=_t(table))
    for a, b in ((t.s, j.s), (t.R, j.R), (t.t, j.t)):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-4)
    assert int(t.n_inliers) == int(j.n_inliers) > 0.5 * valid.sum()
    np.testing.assert_array_equal(t.inliers.numpy(), _np(j.inliers))
    if fix:
        assert float(t.s) == 1.0


# ---------------------------------------------------------------------------
# pose graph
# ---------------------------------------------------------------------------

GRAPHS = {"sim3": (lambda: build_drifty_graph()[0], {}),
          "fix_scale": (lambda: build_drifty_graph(drift_scale=1.0)[0],
                        dict(fix_scale=True)),
          "four_dof": (lambda: _ring_graph()[0], dict(four_dof=True))}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_pose_graph_parity(name):
    make, kw = GRAPHS[name]
    g = make()
    js, jR, jt, jc = j_pg.optimize(g, n_iters=8, **kw)
    ts, tR, tt, tc = pose_graph.optimize(
        convert.pose_graph_from_numpy({k: _np(v) for k, v in
                                       g._asdict().items()}),
        n_iters=8, **kw)
    for a, b in ((ts, js), (tR, jR), (tt, jt)):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-4)
    _close_rel(tc.numpy(), _np(jc), 1e-3)


@pytest.mark.parametrize("world_side", [False, True])
def test_edge_jacobian_at_zero(world_side):
    g, _ = build_drifty_graph(n=8)
    E = 6
    Si = tuple(_np(x)[_np(g.edge_i)[:E]] for x in (g.s, g.R, g.t))
    Sj = tuple(_np(x)[_np(g.edge_j)[:E]] for x in (g.s, g.R, g.t))
    Sij = tuple(_np(x)[:E] for x in (g.edge_s, g.edge_R, g.edge_t))
    # a pure-translation edge: identity rotations, unit scales
    Si = (np.r_[Si[0][:-1], 1.0].astype(np.float32),
          np.concatenate([Si[1][:-1], np.eye(3, dtype=np.float32)[None]]),
          np.concatenate([Si[2][:-1], np.float32([[0.3, -0.2, 0.1]])]))
    Sj = (np.r_[Sj[0][:-1], 1.0].astype(np.float32),
          np.concatenate([Sj[1][:-1], np.eye(3, dtype=np.float32)[None]]),
          np.concatenate([Sj[2][:-1], np.float32([[0.1, 0.0, -0.2]])]))
    Sij = (np.r_[Sij[0][:-1], 1.0].astype(np.float32),
           np.concatenate([Sij[1][:-1], np.eye(3, dtype=np.float32)[None]]),
           np.concatenate([Sij[2][:-1], np.float32([[0.2, -0.2, 0.3]])]))
    z = jnp.zeros(14, jnp.float32)
    jJ = jax.jit(jax.vmap(lambda a, b, c: jax.jacfwd(
        lambda x: j_pg._edge_residual(x[:7], x[7:], a, b, c,
                                      world_side=world_side))(z),
        in_axes=((0, 0, 0),) * 3))(
        tuple(map(jnp.asarray, Si)), tuple(map(jnp.asarray, Sj)),
        tuple(map(jnp.asarray, Sij)))
    r, J = pose_graph.edge_terms(tuple(map(_t, Si)), tuple(map(_t, Sj)),
                                 tuple(map(_t, Sij)), world_side)
    assert J.shape == (E, 7, 14) and torch.isfinite(J).all()
    np.testing.assert_allclose(J.numpy(), _np(jJ), atol=1e-5)


@pytest.mark.parametrize("name", ["sim3", "four_dof"])
def test_normal_equations_match_reference(name):
    make, _ = GRAPHS[name]
    g = make()
    world_side = name == "four_dof"
    ei, ej = _np(g.edge_i), _np(g.edge_j)
    S = [tuple(jnp.asarray(_np(x)[idx]) for x in (g.s, g.R, g.t))
         for idx in (ei, ej)]
    Sij = (g.edge_s, g.edge_R, g.edge_t)

    def res(x, a, b, c):
        return j_pg._edge_residual(x[:7], x[7:], a, b, c,
                                   world_side=world_side)
    z = jnp.zeros(14, jnp.float32)
    ax = ((0, 0, 0),) * 3
    r, J = jax.jit(jax.vmap(lambda a, b, c: (res(z, a, b, c),
                                             jax.jacfwd(res)(z, a, b, c)),
                            in_axes=ax))(S[0], S[1], Sij)
    r, J = np.asarray(r, np.float64), np.asarray(J, np.float64)
    K = g.s.shape[0]
    w = _np(g.edge_w).astype(np.float64)
    H0 = np.zeros((K, 7, K, 7))
    b0 = np.zeros((K, 7))
    for e in range(ei.shape[0]):
        Ji, Jj = J[e, :, :7] * w[e], J[e, :, 7:] * w[e]
        H0[ei[e], :, ei[e], :] += Ji.T @ J[e, :, :7]
        H0[ej[e], :, ej[e], :] += Jj.T @ J[e, :, 7:]
        H0[ei[e], :, ej[e], :] += Ji.T @ J[e, :, 7:]
        H0[ej[e], :, ei[e], :] += Jj.T @ J[e, :, :7]
        b0[ei[e]] -= Ji.T @ r[e]
        b0[ej[e]] -= Jj.T @ r[e]
    H0, b0 = H0.reshape(7 * K, 7 * K), b0.reshape(7 * K)
    c0 = float(np.sum(w * np.sum(r * r, axis=-1)))
    tg = convert.pose_graph_from_numpy({k: _np(v) for k, v in
                                        g._asdict().items()})
    H, b, c = pose_graph.normal_equations_plain(tg, tg.s, tg.R, tg.t,
                                                world_side)
    d = np.sqrt(np.clip(np.diagonal(H0), 1e-30, None))
    eH = np.max(np.abs(H.double().numpy() - H0) / d[:, None] / d[None, :])
    eb = np.max(np.abs(b.double().numpy() - b0) / d) / \
        np.max(np.abs(b0) / d)
    assert eH < 1e-5 and eb < 1e-5, (eH, eb)
    assert abs(float(c) - c0) <= 1e-5 * c0, (float(c), c0)


# ---------------------------------------------------------------------------
# PCG bundle adjustment
# ---------------------------------------------------------------------------

def _port_problem(prob):
    p = ba.BAProblem(*(_t(x) for x in prob))
    return p._replace(obs_kf=p.obs_kf.int(), obs_lm=p.obs_lm.int())


@pytest.fixture(scope="module")
def pcg_case():
    prob, _ = _synthetic_problem()
    return prob, _port_problem(prob)


def test_ba_solve_pcg_parity(pcg_case):
    prob, p = pcg_case
    _, _, _, ji = j_ba.ba_solve_pcg(prob, n_iters=6, cg_iters=40)
    R, t, X, info = ba.ba_solve_pcg(p, n_iters=6, cg_iters=40)
    _close_rel(info["cost0"].numpy(), _np(ji["cost0"]), 1e-3)
    jc = _np(ji["costs"])
    np.testing.assert_allclose(info["costs"].numpy(), jc, rtol=1e-3)
    j_acc = np.r_[jc[0] < float(ji["cost0"]), jc[1:] < jc[:-1]]
    assert info["accepted"].numpy()[:4].tolist() == j_acc[:4].tolist()
    assert info["costs"][-1] < 1e-2 * info["cost0"]
    # two carry-resumed slices of 3 equal one call of 6
    _, _, _, i1 = ba.ba_solve_pcg(p, n_iters=3, cg_iters=40)
    R2, t2, X2, i2 = ba.ba_solve_pcg(p, n_iters=3, cg_iters=40,
                                     carry=i1["carry"])
    for a, b in ((R2, R), (t2, t), (X2, X)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(
        torch.cat([i1["costs"], i2["costs"]]).numpy(), info["costs"].numpy())
    # JAX's carry crosses to the port: its cost is the port's cost there
    R3, t3, X3, _, c3 = convert.pcg_carry_from_numpy(
        tuple(map(_np, ji["carry"])))
    _close_rel(ba.assemble(p, R3, t3, X3, per_obs=True).cost.numpy(),
               c3.numpy(), 1e-3)


def test_schur_product_parity(pcg_case):
    """K14's plain passes against the reference's S_matvec, right-hand side
    and back-substitution on the same damped blocks; K4's per-observation
    blocks against `_assemble_blocks`."""
    prob, p = pcg_case
    lam = 1e-2
    Hpp, Hll_inv, bp, bl, Wpl = j_ba._assemble_blocks(prob, prob.R, prob.t,
                                                      prob.X, lam)
    ob = ba.assemble(p, p.R, p.t, p.X, per_obs=True)
    _close_rel(ob.Wpl.numpy(), _np(Wpl), 1e-5)
    _close_rel(ba._damp(ob.Hpp, torch.tensor(lam)).numpy(), _np(Hpp), 1e-5)
    _close_rel(ob.bp.numpy(), _np(bp), 1e-5)
    K, L = p.R.shape[0], p.X.shape[0]
    kf_f = prob.kf_opt.astype(jnp.float32)
    lm_f = prob.lm_opt.astype(jnp.float32)
    x = np.random.default_rng(5).normal(size=(K, 6)).astype(np.float32)

    def j_matvec(xp):
        xp = xp * kf_f[:, None]
        Btx = jax.ops.segment_sum(jnp.einsum('oab,oa->ob', Wpl,
                                             xp[prob.obs_kf]),
                                  prob.obs_lm, num_segments=L)
        y = jnp.einsum('lab,lb->la', Hll_inv, Btx) * lm_f[:, None]
        By = jax.ops.segment_sum(jnp.einsum('oab,ob->oa', Wpl,
                                            y[prob.obs_lm]),
                                 prob.obs_kf, num_segments=K)
        return (jnp.einsum('kab,kb->ka', Hpp, xp) - By) * kf_f[:, None]
    tW, tH, tHi = _t(Wpl), _t(Hpp), _t(Hll_inv)
    _close_rel(ba.schur_matvec(p, tW, tH, tHi, _t(x)).numpy(),
               _np(j_matvec(jnp.asarray(x))), 1e-5)
    y0 = jnp.einsum('lab,lb->la', Hll_inv, bl)
    By0 = jax.ops.segment_sum(jnp.einsum('oab,ob->oa', Wpl, y0[prob.obs_lm]),
                              prob.obs_kf, num_segments=K)
    _close_rel(ba.schur_kf_pass(p, tW, _t(y0), a=_t(bp)).numpy(),
               _np((bp - By0) * kf_f[:, None]), 1e-5)
    dxp = jnp.asarray(x) * kf_f[:, None]
    Btd = jax.ops.segment_sum(jnp.einsum('oab,oa->ob', Wpl,
                                         dxp[prob.obs_kf]),
                              prob.obs_lm, num_segments=L)
    dxl = jnp.einsum('lab,lb->la', Hll_inv, bl - Btd) * lm_f[:, None]
    _close_rel(ba.schur_lm_pass(p, tW, _t(dxp), tHi, c=_t(bl)).numpy(),
               _np(dxl), 1e-5)


# ---------------------------------------------------------------------------
# global BA
# ---------------------------------------------------------------------------

def _gba_map():
    """tests/test_global_ba.py's perturbed 6-keyframe map."""
    rng = np.random.default_rng(1)
    K_cap, F_cap, L_cap, n_pts = 8, 128, 512, 300
    m = j_ms.empty_map(K_cap, F_cap, L_cap)
    X = jnp.asarray(rng.uniform([-2, -2, 4], [2, 2, 9], (n_pts, 3)),
                    jnp.float32)
    for k in range(6):
        R, t = j_lie.se3_exp(jnp.asarray([0.3 * k, 0, 0, 0, 0.04 * k, 0],
                                         jnp.float32))
        Xc = j_lie.se3_apply(R, t, X)
        uv = Xc[:, :2] / Xc[:, 2:3]
        sel = rng.choice(n_pts, F_cap, replace=False)
        m = m._replace(
            kf_R=m.kf_R.at[k].set(R), kf_t=m.kf_t.at[k].set(t),
            kf_valid=m.kf_valid.at[k].set(True),
            kf_ts=m.kf_ts.at[k].set(float(k)),
            kf_prev=m.kf_prev.at[k].set(k - 1),
            kf_feat_xn=m.kf_feat_xn.at[k].set(uv[sel]),
            kf_feat_valid=m.kf_feat_valid.at[k].set(True),
            kf_feat_lm=m.kf_feat_lm.at[k].set(sel.astype(np.int32)))
    m = m._replace(
        lm_pos=m.lm_pos.at[:n_pts].set(
            X + jnp.asarray(rng.normal(0, 0.05, (n_pts, 3)), jnp.float32)),
        lm_valid=m.lm_valid.at[:n_pts].set(True),
        lm_first_ts=m.lm_first_ts.at[:n_pts].set(0.0),
        lm_ref_kf=m.lm_ref_kf.at[:n_pts].set(0),
        n_kf=jnp.asarray(6), n_lm=jnp.asarray(n_pts))
    dR, dt = j_lie.se3_exp(jnp.asarray(rng.normal(0, 0.02, (K_cap, 6)),
                                       jnp.float32))
    Rp, tp = j_lie.se3_mul(dR, dt, m.kf_R, m.kf_t)
    return m._replace(kf_R=m.kf_R.at[1:6].set(Rp[1:6]),
                      kf_t=m.kf_t.at[1:6].set(tp[1:6]))


def test_global_ba_and_reconcile_parity():
    m = _gba_map()
    jcfg = j_lmap.LocalMapConfig(focal=460.0)
    tcfg = local_mapping.LocalMapConfig(focal=460.0)
    jm, ji = j_gba.global_bundle_adjustment(m, jcfg, n_iters=4,
                                            cg_iters=40)
    tm0 = convert.map_from_numpy(_jmap(m))
    tm, ti = global_ba.global_bundle_adjustment(tm0, tcfg, n_iters=4,
                                                cg_iters=40)
    # a monocular map with one fixed keyframe keeps its scale gauge free:
    # float32 rounding moves the two solutions along it, so the camera
    # centres are compared after a Sim3 alignment
    _close_rel(ti["cost0"].numpy(), _np(ji["cost0"]), 1e-5)
    for info in (ti, ji):
        assert float(info["costs"][-1]) < 0.05 * float(info["cost0"])
    np.testing.assert_allclose(tm.kf_R.numpy(), _np(jm.kf_R), atol=1e-5)
    c_t = -lie.matvec(tm.kf_R.transpose(-1, -2), tm.kf_t)[:6]
    c_j = torch.from_numpy(-np.einsum('kji,kj->ki', _np(jm.kf_R),
                                      _np(jm.kf_t))[:6])
    rmse, s_al, _, _ = alignment.ate_rmse(c_t, c_j, with_scale=True)
    assert float(rmse) < 1e-4 and abs(float(s_al) - 1) < 1e-3, (
        float(rmse), float(s_al))
    np.testing.assert_array_equal(tm.kf_feat_lm.numpy(), _np(jm.kf_feat_lm))

    # reconcile into a live map that moved on: keyframe 6 inserted after
    # the snapshot (child of 5), keyframe 3's slot reused by a newer one,
    # a new landmark referenced to keyframe 6
    Rg, tg, Xg = jm.kf_R, jm.kf_t, jm.lm_pos
    rng = np.random.default_rng(4)
    live = m._replace(
        kf_valid=m.kf_valid.at[6].set(True),
        kf_ts=m.kf_ts.at[6].set(6.0).at[3].set(7.0),
        kf_prev=m.kf_prev.at[6].set(5),
        kf_R=m.kf_R.at[6].set(m.kf_R[5]),
        kf_t=m.kf_t.at[6].set(m.kf_t[5] + jnp.asarray([0.1, 0, 0])),
        kf_v=jnp.asarray(rng.normal(size=(8, 3)), jnp.float32),
        lm_valid=m.lm_valid.at[300].set(True),
        lm_pos=m.lm_pos.at[300].set(jnp.asarray([0.5, 0.2, 6.0])),
        lm_first_ts=m.lm_first_ts.at[300].set(6.0),
        lm_ref_kf=m.lm_ref_kf.at[300].set(6))
    jr = j_gba.gba_reconcile(live, m.kf_valid, m.kf_ts, m.lm_valid,
                             m.lm_first_ts, Rg, tg, Xg)
    tl = convert.map_from_numpy(_jmap(live))
    tr = global_ba.gba_reconcile(tl, *(_t(x) for x in (
        m.kf_valid, m.kf_ts, m.lm_valid, m.lm_first_ts, Rg, tg, Xg)))
    for f in ("kf_R", "kf_t", "kf_v", "lm_pos"):
        np.testing.assert_allclose(getattr(tr, f).numpy(),
                                   _np(getattr(jr, f)), atol=1e-5)


# ---------------------------------------------------------------------------
# atlas
# ---------------------------------------------------------------------------

def _atlas_maps():
    rng = np.random.default_rng(0)
    m = j_ms.empty_map(8, 4, 64)
    X = jnp.asarray(rng.uniform(-1, 1, (64, 3)) + [0, 0, 5], jnp.float32)
    R0, t0 = j_lie.se3_exp(jnp.asarray([.1, .2, .3, .05, .02, .01],
                                       jnp.float32))
    m = m._replace(kf_R=m.kf_R.at[0].set(R0), kf_t=m.kf_t.at[0].set(t0),
                   kf_valid=m.kf_valid.at[:3].set(True), lm_pos=X,
                   lm_valid=jnp.ones(64, bool),
                   kf_v=jnp.asarray(rng.normal(size=(8, 3)), jnp.float32),
                   kf_prev=m.kf_prev.at[1].set(0).at[2].set(1),
                   kf_feat_lm=m.kf_feat_lm.at[0, 0].set(6),
                   lm_ref_kf=m.lm_ref_kf.at[:7].set(1),
                   n_kf=jnp.asarray(3), n_lm=jnp.asarray(7))
    act = j_ms.empty_map(8, 4, 64)
    act = act._replace(kf_valid=act.kf_valid.at[:2].set(True),
                       lm_valid=act.lm_valid.at[:5].set(True),
                       n_kf=jnp.asarray(2), n_lm=jnp.asarray(5))
    return m, act


def test_atlas_parity():
    m, act = _atlas_maps()
    s = jnp.asarray(1.7, jnp.float32)
    Rw = j_lie.so3_exp(jnp.asarray([.3, -.2, .5], jnp.float32))
    tw = jnp.asarray([2., -1., .5], jnp.float32)
    ts_, tRw, ttw = _t(s), _t(Rw), _t(tw)
    tm, tact = (convert.map_from_numpy(_jmap(x)) for x in (m, act))
    jt = j_atlas.transform_map(m, s, Rw, tw)
    tt = atlas.transform_map(tm, ts_, tRw, ttw)
    for f in ("kf_R", "kf_t", "lm_pos", "kf_v"):
        np.testing.assert_allclose(getattr(tt, f).numpy(),
                                   _np(getattr(jt, f)), atol=1e-5)
    jmg, jko, jlo = j_atlas.merge_maps(act, m, s, Rw, tw)
    tmg, tko, tlo = atlas.merge_maps(tact, tm, ts_, tRw, ttw)
    assert (int(tko), int(tlo)) == (int(jko), int(jlo)) == (2, 5)
    for f, a in tmg._asdict().items():
        b = _np(getattr(jmg, f))
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b, atol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(a.numpy().view(b.dtype)
                                          if a.dtype == torch.int32 and
                                          b.dtype == np.uint32
                                          else a.numpy(), b, err_msg=f)
    R_n, t_n = j_lie.se3_exp(jnp.asarray([.2, 0, .1, .1, 0, .2],
                                         jnp.float32))
    jw = j_atlas.sim3_from_cam_pair(s, Rw, tw, R_n, t_n, m.kf_R[0],
                                    m.kf_t[0])
    tw_ = atlas.sim3_from_cam_pair(ts_, tRw, ttw, _t(R_n), _t(t_n),
                                   tm.kf_R[0], tm.kf_t[0])
    for a, b in zip(tw_, jw):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-5)
    # a stashed map (map, database, counts, the merge's generation and
    # offset) crosses from the JAX package to the port and back
    from morb_slam_tpu.vocab import database as j_db
    st = j_atlas.StashedMap(gen=2, m=m, db=j_db.empty(8, 16), n_kf=3,
                            merged_into_gen=4, kf_offset=5)
    d = dict(gen=st.gen, m=_jmap(st.m), n_kf=st.n_kf,
             db={k: _np(v) for k, v in st.db._asdict().items()},
             merged_into_gen=st.merged_into_gen, kf_offset=st.kf_offset)
    ts_st = convert.stashed_from_numpy(d)
    assert (ts_st.gen, ts_st.n_kf, ts_st.merged_into_gen,
            ts_st.kf_offset) == (2, 3, 4, 5)
    back = convert.stashed_to_numpy(ts_st)
    for part in ("m", "db"):
        for k, v in d[part].items():
            np.testing.assert_array_equal(back[part][k], v, err_msg=k)
