"""Loop detection, Sim(3) verification, essential-graph correction and the
Atlas merge (counterpart of `morb_slam_tpu/pipeline/loop_closing.py`).

After a keyframe insert, `LoopCloser.maybe_close` queries the keyframe
database (K10) for candidates outside the covisible group, verifies them by
descriptor matching (K3) and a Sim(3) RANSAC on the 3D-3D pairs
(`verify_candidate`), then by guided projection matching and a 7-dof
Gauss-Newton refinement (`guided_sim3_verify`: kernel K18, `window_match`
and `sim3_refine`, `csrc/sim3_verify.cu` on CUDA tensors, their plain
versions on CPU tensors); a loop fires after two consistent detections.
`correct_loop` then redistributes the drift with the Sim(3) pose graph,
`search_and_fuse` welds the two sides' landmarks, and the detached global
BA (`global_ba.GBAJob`, K4 per-observation mode + K14) starts; its first
two slices run at once. `maybe_merge` welds a stashed map back through
the RANSAC verification against the stashed database (`verify_merge`), an
essential-graph pass when several contacts verify, and a weld-window BA.
Every other Hamming search gives its gate to K3, which never forms the
N x M distance matrix. The RANSAC sample tables are drawn from the
tracker's `torch.Generator`. The decisions (inlier counts, candidate
flags) are read on the host, as the reference does.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch.profiler import record_function

from .. import cameras, lie, matching
from ..mapstate import atlas as atlas_mod
from ..mapstate import state as ms
from ..ops import cuda_build, hamming
from ..optim import pose_graph
from ..solvers import sim3 as sim3_solver
from ..tensor_ops import mask_first, put, topk
from ..vocab import database as kfdb
from . import global_ba, local_mapping

MIN_SIM3_INLIERS = 20
MIN_ACCEPT_MATCHES = 35
COVIS_EDGE_MIN = 30        # covisibility weight for pose-graph edges
COVIS_EDGES_PER_KF = 16
MAX_PAST_LOOP_EDGES = 8    # past loop / merge edges kept in the graph
MAX_LOCAL_LM_FUSE = 4096   # loop-side landmark pool of SearchAndFuse
SIM3_HYP = 128


def _kf_landmarks(m: ms.MapState, kf):
    lm = m.kf_feat_lm[kf]
    ok = (lm >= 0) & m.kf_feat_valid[kf] & \
        m.lm_valid[torch.clamp(lm, min=0).long()]
    return lm, ok


def verify_merge(m_new: ms.MapState, kf_id, m_old: ms.MapState, cand, cfg,
                 fix_scale: bool = False, samples=None, generator=None):
    """Geometric verification of a candidate keyframe of m_old (a stashed
    map, or the active one) for keyframe kf_id of m_new: mutual-best
    descriptor matches of their landmark-bound features (K3), then Sim(3)
    RANSAC on the matched points in the two cameras. Returns (s, R, t)
    mapping the candidate's camera points into the keyframe's camera, and
    the inlier count."""
    lm1, ok1 = _kf_landmarks(m_new, kf_id)
    lm2, ok2 = _kf_landmarks(m_old, cand)
    idx, _ = hamming.match_nn(m_new.kf_feat_desc[kf_id],
                              m_old.kf_feat_desc[cand],
                              ok1[:, None] & ok2[None, :], ok1, ok2,
                              max_dist=hamming.TH_LOW, ratio=0.75,
                              cross_check=True)
    j = torch.clamp(idx, min=0).long()
    X1w = m_new.lm_pos[torch.clamp(lm1, min=0).long()]
    X2w = m_old.lm_pos[torch.clamp(lm2[j], min=0).long()]
    X1c = lie.se3_apply(m_new.kf_R[kf_id], m_new.kf_t[kf_id], X1w)
    X2c = lie.se3_apply(m_old.kf_R[cand], m_old.kf_t[cand], X2w)
    res = sim3_solver.solve_sim3(
        X1c, X2c, m_new.kf_feat_xn[kf_id], m_old.kf_feat_xn[cand][j],
        idx >= 0, focal=cfg.focal, fix_scale=fix_scale, n_hyp=SIM3_HYP,
        samples=samples, generator=generator)
    return res.s, res.R, res.t, res.n_inliers


def verify_candidate(m: ms.MapState, kf_id, cand, cfg,
                     fix_scale: bool = False, samples=None, generator=None):
    """Loop verification: `verify_merge` with both keyframes in m."""
    return verify_merge(m, kf_id, m, cand, cfg, fix_scale, samples,
                        generator)


CHI2_SIM3 = 9.21
WINDOW_LAUNCHES = {"kernel": 0, "plain": 0}
REFINE_LAUNCHES = {"kernel": 0, "plain": 0}


def _sim3_flat(s0, R0, t0):
    """(13,) float32 [s, R row-major, t] for K18."""
    return torch.cat([s0.reshape(1), R0.reshape(9), t0.reshape(3)]).to(
        torch.float32).contiguous()


def window_match_plain(X2c, ok2, oct2, desc2, xn1, valid1, desc1, s0, R0,
                       t0, focal: float, scale: float):
    """Plain version of K18's first launch: project the candidate's
    camera-frame landmarks X2c (F, 3) through (s0, R0, t0) into the
    keyframe, gate each pair by the 7.5 px window scaled by the candidate
    feature's octave and by z > 0.05, and match descriptors (TH_HIGH,
    ratio 1, cross check; K3 through `hamming.match_nn`). The projection is
    written per component, summed left to right, as the kernel does.
    Returns idx (F,) int32: the keyframe feature of each candidate
    feature, or -1."""
    WINDOW_LAUNCHES["plain"] += 1
    f32 = X2c.dtype
    X = [s0 * (R0[i, 0] * X2c[:, 0] + R0[i, 1] * X2c[:, 1]
               + R0[i, 2] * X2c[:, 2]) + t0[i] for i in range(3)]
    z = X[2]
    zs = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    px, py = X[0] / zs, X[1] / zs
    rad = 7.5 / focal * scale ** oct2.to(f32)
    dx = px[:, None] - xn1[None, :, 0]
    dy = py[:, None] - xn1[None, :, 1]
    gate = (dx * dx + dy * dy < (rad * rad)[:, None]) & (z > 0.05)[:, None]
    idx, _ = hamming.match_nn(desc2, desc1, gate, ok2, valid1,
                              max_dist=hamming.TH_HIGH, ratio=1.0,
                              cross_check=True)
    return idx


def window_match(X2c, ok2, oct2, desc2, xn1, valid1, desc1, s0, R0, t0,
                 focal: float, scale: float):
    """K18's first launch (`window_match_plain`'s result). CUDA tensors:
    the kernel (raises if it cannot run), which never forms the F x F
    gate or distance matrix; CPU tensors: the plain version."""
    if X2c.device.type == "cpu":
        return window_match_plain(X2c, ok2, oct2, desc2, xn1, valid1, desc1,
                                  s0, R0, t0, focal, scale)
    if X2c.device.type != "cuda":
        raise ValueError(f"window_match: unsupported device {X2c.device}")
    n2, n1 = X2c.shape[0], xn1.shape[0]
    f32, i32 = torch.float32, torch.int32
    want = ((desc2, i32, (n2, 8)), (desc1, i32, (n1, 8)),
            (X2c, f32, (n2, 3)), (ok2, torch.bool, (n2,)),
            (oct2, i32, (n2,)), (xn1, f32, (n1, 2)),
            (valid1, torch.bool, (n1,)))
    if any(t.dtype != d or tuple(t.shape) != sh or t.device != X2c.device
           for t, d, sh in want) or n1 == 0 or n2 == 0:
        raise ValueError("window_match: needs int32 (F, 8) descriptors, "
                         "float32 X2c (F, 3) and xn1 (F, 2), int32 octaves "
                         "and bool flags on one device")
    ins = [hamming._aligned(desc2), hamming._aligned(desc1),
           X2c.contiguous(), ok2.to(torch.uint8).contiguous(),
           oct2.contiguous(), xn1.contiguous(),
           valid1.to(torch.uint8).contiguous(), _sim3_flat(s0, R0, t0)]
    dev = X2c.device
    rows = torch.empty((n2, 4), dtype=f32, device=dev)
    best = torch.empty(n2, dtype=i32, device=dev)
    bidx = torch.empty(n2, dtype=i32, device=dev)
    second = torch.empty(n2, dtype=i32, device=dev)
    col = torch.empty(n1, dtype=i32, device=dev)
    idx = torch.empty(n2, dtype=i32, device=dev)
    rc = _verify_lib().sim3_window_match(
        *(t.data_ptr() for t in ins), n2, n1, 7.5 / focal, scale,
        rows.data_ptr(), best.data_ptr(), bidx.data_ptr(),
        second.data_ptr(), col.data_ptr(), idx.data_ptr(),
        cuda_build.stream_ptr(X2c))
    cuda_build.check(rc, "sim3_window_match")
    WINDOW_LAUNCHES["kernel"] += 1
    return idx


class _Dual:
    """A forward-mode dual number (value v, tangents d: one row a lane) on
    float64 tensors, with the operations of K18's double duals
    (csrc/sim3_verify.cu) in their order, each separately rounded as the
    kernel's (built without FMA)."""
    __slots__ = ("v", "d")

    def __init__(self, v, d):
        self.v, self.d = v, d

    def __add__(self, b):
        return _Dual(self.v + b.v, self.d + b.d)

    def __sub__(self, b):
        return _Dual(self.v - b.v, self.d - b.d)

    def __neg__(self):
        return _Dual(-self.v, -self.d)

    def __mul__(self, b):
        return _Dual(self.v * b.v, self.d * b.v + self.v * b.d)

    def __truediv__(self, b):
        return _Dual(self.v / b.v,
                     (self.d * b.v - self.v * b.d) / (b.v * b.v))

    def scale(self, c):
        """c * self for a constant c."""
        return _Dual(c * self.v, c * self.d)


def _dc(v, dev):
    """A constant dual (zero tangents)."""
    v = v if torch.is_tensor(v) else torch.tensor(v, dtype=torch.float64,
                                                  device=dev)
    return _Dual(v, torch.zeros((), dtype=torch.float64, device=dev))


def _dexp(w, dev):
    """R (9 duals, row-major) = so3_exp(w), the kernel's dexp (lie.py's
    form, its |theta| < 1e-4 series branches)."""
    n2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    n2e = n2 + _dc(1e-24, dev)
    sq = torch.sqrt(n2e.v)
    th = _Dual(sq, n2e.d / (2.0 * sq))
    small = torch.abs(th.v) < 1e-4
    th2 = th * th
    sin_, cos_ = torch.sin(th.v), torch.cos(th.v)
    a_big = _Dual(sin_, cos_ * th.d) / th
    a_small = _dc(1.0, dev) - th2.scale(1.0 / 6.0)
    b_big = (_dc(1.0, dev) - _Dual(cos_, -sin_ * th.d)) / th2
    b_small = _dc(0.5, dev) - th2.scale(1.0 / 24.0)
    a = _Dual(torch.where(small, a_small.v, a_big.v),
              torch.where(small, a_small.d, a_big.d))
    b = _Dual(torch.where(small, b_small.v, b_big.v),
              torch.where(small, b_small.d, b_big.d))
    zero = _dc(0.0, dev)
    W = [zero, -w[2], w[1], w[2], zero, -w[0], -w[1], w[0], zero]
    return [_dc(1.0 if i == j else 0.0, dev) + a * W[3 * i + j]
            + b * (w[i] * w[j] - (n2 if i == j else zero))
            for i in range(3) for j in range(3)]


def _sim3_duals(x, sim, dev):
    """The kernel's sim3_duals for every lane at once: the 26 duals [s, R
    (9), t (3), s^-1, R^T (9), -(s^-1) R^T t] of (s0 exp(x0), R0
    exp(x1..3), t0 + x4..6), lane q carrying the unit tangent e_q."""
    lanes = torch.eye(7, dtype=torch.float64, device=dev)[:, :, None]
    xd = [_Dual(x[q], lanes[q]) for q in range(7)]
    ex = torch.exp(xd[0].v)
    s = _Dual(sim[0] * ex, sim[0] * ex * xd[0].d)
    E = _dexp(xd[1:4], dev)
    R0 = [_dc(sim[1 + k], dev) for k in range(9)]
    R = [R0[3 * i] * E[j] + R0[3 * i + 1] * E[3 + j] + R0[3 * i + 2]
         * E[6 + j] for i in range(3) for j in range(3)]
    t = [_dc(sim[10 + q], dev) + xd[4 + q] for q in range(3)]
    si = _dc(1.0, dev) / s
    Ri = [R[3 * j + i] for i in range(3) for j in range(3)]
    Rt = [Ri[3 * i] * t[0] + Ri[3 * i + 1] * t[1] + Ri[3 * i + 2] * t[2]
          for i in range(3)]
    return [s] + R + t + [si] + Ri + [-(si * Rt[q]) for q in range(3)]


def _reproj(T, X, ob, dev):
    """The kernel's reproj of points X (F, 3) through the Sim(3) duals T
    against observations ob (F, 2): two duals, values (F,), tangents
    (7, F)."""
    P = [T[0] * (T[1 + 3 * k] * _dc(X[:, 0], dev) + T[2 + 3 * k]
                 * _dc(X[:, 1], dev) + T[3 + 3 * k] * _dc(X[:, 2], dev))
         + T[10 + k] for k in range(3)]
    near = torch.abs(P[2].v) < 1e-6
    z = _Dual(torch.where(near, torch.full_like(P[2].v, 1e-6), P[2].v),
              torch.where(near, torch.zeros_like(P[2].d), P[2].d))
    return (P[0] / z - _dc(ob[:, 0], dev), P[1] / z - _dc(ob[:, 1], dev))


def _cholesky_step(sums, x):
    """x - dx for (H + 1e-4 I) dx = g by the kernel's Cholesky, on Python
    floats (IEEE double, the kernel's order of operations)."""
    L = [[0.0] * 7 for _ in range(7)]
    q = 0
    for a in range(7):
        for b in range(a, 7):
            L[b][a] = L[a][b] = sums[q]
            q += 1
    for a in range(7):
        L[a][a] += 1e-4
    for j in range(7):
        d = L[j][j]
        for k in range(j):
            d -= L[j][k] * L[j][k]
        d = math.sqrt(max(d, 1e-300))
        L[j][j] = d
        for i in range(j + 1, 7):
            v = L[i][j]
            for k in range(j):
                v -= L[i][k] * L[j][k]
            L[i][j] = v / d
    y = [0.0] * 7
    for i in range(7):
        v = sums[28 + i]
        for k in range(i):
            v -= L[i][k] * y[k]
        y[i] = v / L[i][i]
    for i in range(6, -1, -1):
        v = y[i]
        for k in range(i + 1, 7):
            v -= L[k][i] * y[k]
        y[i] = v / L[i][i]
    return [x[i] - y[i] for i in range(7)]


def sim3_refine_plain(X2c, X1c_own, xn1_j, xn2, info1, pair_ok, has_inv,
                      s0, R0, t0):
    """Plain version of K18's second launch: 2 rounds of 5 Gauss-Newton
    steps of the 7-dof Sim(3) (log scale, rotation, translation about
    (s0, R0, t0)) on the forward residuals (the candidate's landmarks into
    the keyframe) and the backward ones (the keyframe's own landmarks at
    the matched slots into the candidate), each weighted by info1 and
    reclassified at chi2 9.21 after each round. Computed in float64, as
    the kernel computes it: the residuals and their 7 Jacobian columns on
    dual numbers, the 7 x 7 system summed in the kernel's order (128
    strided partial sums, then those in order) and solved by its
    Cholesky. A candidate seen from near the keyframe's own position
    leaves the scale to the 1e-4 damping alone (H's eigenvalues from
    ~1e-9), where float32 rounding of the Jacobians moves s by ~3e-3.
    Returns (s, R, t float32, n_good: the forward pairs inside the gate
    after the last round)."""
    REFINE_LAUNCHES["plain"] += 1
    f64, dev = torch.float64, X2c.device
    n = X2c.shape[0]
    sim = _sim3_flat(s0, R0, t0).to(f64)
    w = info1.to(f64)
    act = [pair_ok.clone(), has_inv.clone()]
    pts = ((X2c.to(f64), xn1_j.to(f64), 0), (X1c_own.to(f64), xn2.to(f64),
                                               13))
    iu = torch.triu_indices(7, 7, device=dev)
    m = -(-n // 128)
    x = [0.0] * 7

    def duals():
        return _sim3_duals(torch.tensor(x, dtype=f64, device=dev), sim, dev)
    for _ in range(2):
        for _ in range(5):
            T = duals()
            terms = []
            for (X, ob, off), a in zip(pts, act):
                r0, r1 = _reproj(T[off:off + 13], X, ob, dev)
                J0, J1 = r0.d.T, r1.d.T                          # (F, 7)
                h = w[:, None] * (J0[:, iu[0]] * J0[:, iu[1]]
                                  + J1[:, iu[0]] * J1[:, iu[1]])
                g = w[:, None] * (J0 * r0.v[:, None] + J1 * r1.v[:, None])
                t = torch.cat([h, g], dim=1)
                terms.append(torch.where(a[:, None], t,
                                         torch.zeros_like(t)))
            # thread k sums features k, k + 128, ... (forward, then
            # backward, each), then the block sums the threads in order
            tt = torch.zeros((m * 128, 2, 35), dtype=f64, device=dev)
            tt[:n] = torch.stack(terms, dim=1)
            tt = tt.reshape(m, 128, 2, 35)
            part = torch.zeros((128, 35), dtype=f64, device=dev)
            for j in range(m):
                part = part + tt[j, :, 0]
                part = part + tt[j, :, 1]
            sums = torch.zeros(35, dtype=f64, device=dev)
            for k in range(128):
                sums = sums + part[k]
            x = _cholesky_step(sums.tolist(), x)
        T = duals()
        for (X, ob, off), base, k in zip(pts, (pair_ok, has_inv), (0, 1)):
            r0, r1 = _reproj(T[off:off + 13], X, ob, dev)
            act[k] = base & ((r0.v * r0.v + r1.v * r1.v) * w < CHI2_SIM3)
    T = duals()
    s = T[0].v.float()
    R = torch.stack([T[1 + k].v for k in range(9)]).reshape(3, 3).float()
    t = torch.stack([T[10 + q].v for q in range(3)]).float()
    return s, R, t, torch.sum(act[0])


def sim3_refine(X2c, X1c_own, xn1_j, xn2, info1, pair_ok, has_inv, s0, R0,
                t0):
    """K18's second launch (`sim3_refine_plain`'s result; n_good an int32
    device scalar from the kernel). CUDA tensors: the kernel, one launch
    of a cluster of 8 blocks that runs every step without a host read
    (raises if it cannot run); CPU tensors: the plain version."""
    if X2c.device.type == "cpu":
        return sim3_refine_plain(X2c, X1c_own, xn1_j, xn2, info1, pair_ok,
                                 has_inv, s0, R0, t0)
    if X2c.device.type != "cuda":
        raise ValueError(f"sim3_refine: unsupported device {X2c.device}")
    n = X2c.shape[0]
    f32 = torch.float32
    want = ((X2c, f32, (n, 3)), (X1c_own, f32, (n, 3)), (xn1_j, f32, (n, 2)),
            (xn2, f32, (n, 2)), (info1, f32, (n,)),
            (pair_ok, torch.bool, (n,)), (has_inv, torch.bool, (n,)))
    if any(t.dtype != d or tuple(t.shape) != sh or t.device != X2c.device
           for t, d, sh in want):
        raise ValueError("sim3_refine: needs float32 (F, 3) points, (F, 2) "
                         "observations, (F,) weights and bool flags on one "
                         "device")
    ins = [t.contiguous() for t, _, _ in want[:5]] + \
        [t.to(torch.uint8).contiguous() for t, _, _ in want[5:]] + \
        [_sim3_flat(s0, R0, t0)]
    dev = X2c.device
    act = torch.empty((2, n), dtype=torch.uint8, device=dev)
    out = torch.empty(13, dtype=f32, device=dev)
    n_good = torch.empty((), dtype=torch.int32, device=dev)
    rc = _verify_lib().sim3_refine(
        *(t.data_ptr() for t in ins), n, act.data_ptr(), out.data_ptr(),
        n_good.data_ptr(), cuda_build.stream_ptr(X2c))
    cuda_build.check(rc, "sim3_refine")
    REFINE_LAUNCHES["kernel"] += 1
    return out[0], out[1:10].reshape(3, 3), out[10:13], n_good


def _verify_lib():
    lib = cuda_build.library("sim3_verify")
    if lib.sim3_refine.argtypes is None:
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sim3_window_match.argtypes = [P] * 8 + [I, I, Fl, Fl] + [P] * 7
        lib.sim3_window_match.restype = I
        lib.sim3_refine.argtypes = [P] * 8 + [I, P, P, P, P]
        lib.sim3_refine.restype = I
    return lib


@record_function("guided_sim3_verify")
def guided_sim3_verify(m: ms.MapState, kf_id, cand, s0, R0, t0, cfg):
    """Guided projection matching + Sim(3) Gauss-Newton: project the
    candidate's landmarks through (s0, R0, t0) into the keyframe, match in
    a 7.5 px window scaled by octave (`window_match`), refine (s, R, t) on
    the pairs with two-sided reprojection residuals (`sim3_refine`: 2
    rounds of 5 steps, outliers reclassified at chi2 9.21 between them);
    both K18. Returns (s, R, t, n_matches)."""
    dev = m.kf_t.device
    lm2, ok2 = _kf_landmarks(m, cand)
    X2c = lie.se3_apply(m.kf_R[cand], m.kf_t[cand],
                        m.lm_pos[torch.clamp(lm2, min=0).long()])
    ok2 = ok2 & (X2c[:, 2] > 0.05)
    lm1, ok1 = _kf_landmarks(m, kf_id)
    X1c = lie.se3_apply(m.kf_R[kf_id], m.kf_t[kf_id],
                        m.lm_pos[torch.clamp(lm1, min=0).long()])
    ok1 = ok1 & (X1c[:, 2] > 0.05)
    xn1 = m.kf_feat_xn[kf_id]
    idx = window_match(X2c, ok2, m.kf_feat_octave[cand],
                       m.kf_feat_desc[cand], xn1, m.kf_feat_valid[kf_id],
                       m.kf_feat_desc[kf_id], s0, R0, t0, cfg.focal,
                       cfg.scale)
    j1 = torch.clamp(idx, min=0).long()
    pair_ok = (idx >= 0) & ok2
    info1 = (cfg.focal ** 2) * cfg.lm_cfg.sigma2_inv(dev)[torch.clamp(
        m.kf_feat_octave[kf_id][j1], 0, cfg.n_levels - 1).long()]
    return sim3_refine(X2c, X1c[j1], xn1[j1], m.kf_feat_xn[cand], info1,
                       pair_ok, pair_ok & ok1[j1], s0, R0, t0)


@record_function("search_and_fuse")
def search_and_fuse(m: ms.MapState, kf_id, cand, cam: cameras.Camera, cfg):
    """Landmark weld after the correction: project the candidate side's
    landmarks (its covisible neighbourhood) into the keyframe's covisible
    window and bind them, replacing the current side's duplicates."""
    K = m.kf_valid.shape[0]
    L = m.lm_valid.shape[0]
    dev = m.kf_t.device
    src_idx, src_ok = ms.local_window(m, cand, min(6, K), min_weight=10)
    src_slots = m.kf_feat_lm[src_idx]
    src_valid = (src_slots >= 0) & m.kf_feat_valid[src_idx] & \
        src_ok[:, None] & m.lm_valid[torch.clamp(src_slots, min=0).long()]
    pool = torch.where(src_valid, src_slots,
                       torch.full_like(src_slots, L)).reshape(-1).long()
    in_pool = torch.zeros(L + 1, dtype=torch.bool, device=dev)
    in_pool[pool] = True
    in_pool = in_pool[:L] & m.lm_valid
    ids = mask_first(in_pool, min(MAX_LOCAL_LM_FUSE, L))
    pool_ok = in_pool[ids]
    dst_idx, dst_ok = ms.local_window(m, kf_id, min(8, K), min_weight=10)
    for i in range(dst_idx.shape[0]):
        dst_kf = dst_idx[i]
        dst_lm = m.kf_feat_lm[dst_kf]
        seen = torch.zeros(L + 1, dtype=torch.bool, device=dev)
        seen[torch.where(dst_lm >= 0, dst_lm,
                         torch.full_like(dst_lm, L)).long()] = True
        res = matching.search_by_projection(
            m.lm_pos[ids], m.lm_normal[ids], m.lm_dist_max[ids],
            m.lm_desc[ids], pool_ok & ~seen[ids] & dst_ok[i],
            m.kf_R[dst_kf], m.kf_t[dst_kf],
            lambda Xc: cameras.project(cam, Xc),
            m.kf_feat_uv[dst_kf], m.kf_feat_octave[dst_kf],
            m.kf_feat_desc[dst_kf], m.kf_feat_valid[dst_kf],
            (10000, 10000), radius_px=4.0, scale=cfg.scale,
            n_levels=cfg.n_levels, max_dist_th=50, ratio=1.0)
        new_lm = torch.where(res.feat_lm >= 0,
                             ids[torch.clamp(res.feat_lm, min=0).long()]
                             .to(dst_lm.dtype), dst_lm)
        m = m._replace(kf_feat_lm=put(m.kf_feat_lm, dst_kf[None],
                                      new_lm[None]))
    return ms.update_landmark_stats(m)


def correct_loop(m: ms.MapState, kf_id, cand, s_rel, R_rel, t_rel,
                 four_dof: bool = False, past_i=None, past_j=None,
                 past_ok=None, extra_i=None, extra_j=None, extra_s=None,
                 extra_R=None, extra_t=None, extra_ok=None):
    """Essential-graph correction: edges of the temporal chain, each
    keyframe's top-16 covisible neighbours (weight >= 30), the past loop
    edges and extra measured Sim(3) edges (the merge's further contacts),
    and the loop edge kf_id <- cand measured by (s_rel, R_rel, t_rel);
    12 pose-graph iterations with the candidate and keyframe 0 fixed; every
    landmark follows its reference keyframe's correction; keyframes go
    back to SE(3) and their world velocities rotate with them. Returns
    (map, pose-graph costs)."""
    K = m.kf_valid.shape[0]
    f32, dev = m.kf_t.dtype, m.kf_t.device
    i32 = torch.int32
    ones = torch.ones(K, dtype=f32, device=dev)
    W = ms.covisibility_matrix(m)
    prev = m.kf_prev.long()
    chain_ok = (prev >= 0) & m.kf_valid & m.kf_valid[torch.clamp(prev, min=0)]
    covis_w, covis_j = topk(W, COVIS_EDGES_PER_KF)             # (K, C)
    covis_ok = (covis_w >= COVIS_EDGE_MIN) & m.kf_valid[:, None] & \
        m.kf_valid[covis_j]
    if past_i is None:
        past_i = torch.zeros(MAX_PAST_LOOP_EDGES, dtype=i32, device=dev)
        past_j = torch.zeros_like(past_i)
        past_ok = torch.zeros(MAX_PAST_LOOP_EDGES, dtype=torch.bool,
                              device=dev)
    past_ok = past_ok & m.kf_valid[past_i.long()] & m.kf_valid[past_j.long()]
    if extra_i is None:
        extra_i = torch.zeros(1, dtype=i32, device=dev)
        extra_j = torch.zeros_like(extra_i)
        extra_s = torch.ones(1, dtype=f32, device=dev)
        extra_R = torch.eye(3, dtype=f32, device=dev)[None]
        extra_t = torch.zeros((1, 3), dtype=f32, device=dev)
        extra_ok = torch.zeros(1, dtype=torch.bool, device=dev)
    extra_ok = extra_ok & m.kf_valid[extra_i.long()] & \
        m.kf_valid[extra_j.long()]
    ar = torch.arange(K, dtype=i32, device=dev)
    kf_t_ = torch.as_tensor(kf_id, dtype=i32, device=dev).reshape(1)
    cand_t = torch.as_tensor(cand, dtype=i32, device=dev).reshape(1)
    e_i = torch.cat([ar, ar.repeat_interleave(COVIS_EDGES_PER_KF),
                     past_i.to(i32), extra_i.to(i32), kf_t_])
    e_j = torch.cat([torch.clamp(prev, min=0).to(i32),
                     covis_j.reshape(-1).to(i32), past_j.to(i32),
                     extra_j.to(i32), cand_t])
    e_w = torch.cat([chain_ok.to(f32), covis_ok.reshape(-1).to(f32) * 0.5,
                     past_ok.to(f32) * 10.0, extra_ok.to(f32) * 20.0,
                     torch.full((1,), 20.0, dtype=f32, device=dev)])
    ei, ej = e_i.long(), e_j.long()
    # measured relative transforms from the current poses, except the
    # extra edges and the loop edge (the Sim(3) solver's measurements)
    sij, Rij, tij = pose_graph.relative_sim3(ones[ei], m.kf_R[ei],
                                             m.kf_t[ei], ones[ej],
                                             m.kf_R[ej], m.kf_t[ej])
    nE = extra_i.shape[0]
    a0 = sij.shape[0] - 1 - nE
    sij = torch.cat([sij[:a0], extra_s.to(f32),
                     torch.as_tensor(s_rel, dtype=f32, device=dev)
                     .reshape(1)])
    Rij = torch.cat([Rij[:a0], extra_R.to(f32),
                     torch.as_tensor(R_rel, dtype=f32, device=dev)[None]])
    tij = torch.cat([tij[:a0], extra_t.to(f32),
                     torch.as_tensor(t_rel, dtype=f32, device=dev)[None]])
    idx = torch.arange(K, device=dev)
    g = pose_graph.PoseGraph(
        s=ones, R=m.kf_R, t=m.kf_t, edge_i=e_i, edge_j=e_j, edge_s=sij,
        edge_R=Rij, edge_t=tij, edge_w=e_w,
        fixed=(~m.kf_valid) | (idx == cand_t.long()) | (idx == 0))
    s_new, R_new, t_new, costs = pose_graph.optimize(g, n_iters=12,
                                                     four_dof=four_dof)
    # landmarks: X' = S_new_r^-1 (T_old_r X) through each reference keyframe
    ref = torch.clamp(m.lm_ref_kf, 0, K - 1).long()
    Xc = lie.se3_apply(m.kf_R[ref], m.kf_t[ref], m.lm_pos)
    si, Ri, ti = lie.sim3_inv(s_new[ref], R_new[ref], t_new[ref])
    lm_pos = torch.where(m.lm_valid[:, None],
                         lie.sim3_apply(si, Ri, ti, Xc), m.lm_pos)
    t_se3 = t_new / s_new[:, None]
    R_cor = lie.matmat(R_new.transpose(-1, -2), m.kf_R)
    v_new = lie.matvec(R_cor, m.kf_v) / s_new[:, None]
    kv = m.kf_valid
    return m._replace(
        kf_R=torch.where(kv[:, None, None], R_new, m.kf_R),
        kf_t=torch.where(kv[:, None], t_se3, m.kf_t),
        kf_v=torch.where(kv[:, None], v_new, m.kf_v),
        lm_pos=lm_pos), costs


def _fix_scale(tracker, cfg):
    """Metric maps (stereo / RGB-D, or IMU-initialized) take no scale from
    a loop or merge Sim(3)."""
    return bool(cfg.baseline > 0) or bool(getattr(tracker, "imu_ready",
                                                  False))


class LoopCloser:
    """Host-side loop-closing orchestration: detection, verification,
    temporal consistency, correction and the detached global BA; the Atlas
    merge. `cfg` is the tracker's TrackerConfig."""

    def __init__(self, cfg, min_interval: int = 10, temporal_hits: int = 2):
        self.cfg = cfg
        self.last_loop_kf = -10 ** 9
        self.min_interval = min_interval
        # a loop fires after `temporal_hits` consecutive keyframes verify
        # candidates in one covisible region
        self.temporal_hits = temporal_hits
        self._pending_cand = -1
        self._pending_kf = -1
        self._pending_count = 0
        # the last verified Sim(3) and the keyframe slot it was verified
        # from, carried forward and refined by guided matching
        self._pending_sim3 = None
        self._pending_slot = -1
        # past loop edges: (kf slot, cand slot) kept in later graphs
        self.past_loop_edges = []

    def _reset_pending(self):
        self._pending_count = 0
        self._pending_cand = -1
        self._pending_sim3 = None
        self._pending_slot = -1

    @record_function("maybe_close")
    def maybe_close(self, tracker, kf_id: int, bow) -> bool:
        """After a keyframe insert: True when a loop was closed
        (tracker.m updated)."""
        if tracker.db is None or tracker.n_kf_host < 12:
            return False
        seq = tracker.kf_seq
        if seq - self.last_loop_kf < self.min_interval:
            return False
        cfg = self.cfg
        m = tracker.m
        K = m.kf_valid.shape[0]
        row = ms.covisibility_row(m, kf_id)
        ts_v = torch.where(m.kf_valid, m.kf_ts,
                           torch.full_like(m.kf_ts, float("-inf")))
        thr = topk(ts_v, min(6, K))[0][-1]
        exclude = (row > 0) | (m.kf_ts >= thr) | (~m.kf_valid)
        ids, _, ok = kfdb.top_candidates_grouped(
            tracker.db, bow, 3, ms.covisibility_matrix(m), exclude=exclude,
            min_score=0.15)
        fix_scale = _fix_scale(tracker, cfg)
        hit = None
        refined_from_last = False
        if (self._pending_sim3 is not None
                and seq - self._pending_kf <= 2
                and bool(m.kf_valid[self._pending_slot])
                and bool(m.kf_valid[self._pending_cand])):
            # carry the last verified Sim(3) through the odometry since its
            # keyframe and re-verify by guided matching only
            s_p, R_p, t_p = self._pending_sim3
            R_rel, t_rel = lie.se3_mul(
                m.kf_R[kf_id], m.kf_t[kf_id],
                *lie.se3_inv(m.kf_R[self._pending_slot],
                             m.kf_t[self._pending_slot]))
            s, R, t, n_good = guided_sim3_verify(
                m, kf_id, self._pending_cand, s_p, lie.matmat(R_rel, R_p),
                lie.matvec(R_rel, t_p) + t_rel, cfg)
            n_good = int(n_good)
            if n_good >= MIN_ACCEPT_MATCHES:
                hit = (self._pending_cand, s, R, t, n_good)
                refined_from_last = True
        if hit is None:
            ids_h, ok_h = torch.stack([ids, ok.to(ids.dtype)]).tolist()
            for c, good in zip(ids_h, ok_h):
                if not good:
                    continue
                s, R, t, n_inl = verify_candidate(
                    m, kf_id, c, cfg, fix_scale=fix_scale,
                    generator=tracker.generator)
                if int(n_inl) < MIN_SIM3_INLIERS:
                    continue
                s, R, t, n_good = guided_sim3_verify(m, kf_id, c, s, R, t,
                                                     cfg)
                n_good = int(n_good)
                if n_good < MIN_ACCEPT_MATCHES:
                    continue
                hit = (c, s, R, t, n_good)
                break
        if hit is None:
            # a broken streak of detections resets the counter
            if seq - self._pending_kf > 2:
                self._reset_pending()
            return False
        cand, s, R, t, _ = hit
        consistent = refined_from_last or (
            self._pending_cand >= 0 and seq - self._pending_kf <= 2
            and (cand == self._pending_cand or int(
                ms.covisibility_row(m, cand)[self._pending_cand]) > 0))
        self._pending_cand = cand
        self._pending_kf = seq
        self._pending_sim3 = (s, R, t)
        self._pending_slot = kf_id
        self._pending_count = self._pending_count + 1 if consistent else 1
        if self._pending_count < self.temporal_hits:
            return False
        if bool(getattr(tracker, "imu_ready", False)):
            # gravity-aligned maps: a loop's drift must be mostly yaw
            one = torch.ones((), dtype=m.kf_t.dtype, device=m.kf_t.device)
            _, Rij, _ = pose_graph.relative_sim3(
                one, m.kf_R[kf_id], m.kf_t[kf_id], one, m.kf_R[cand],
                m.kf_t[cand])
            r = lie.so3_log(lie.matmat(R, Rij.transpose(-1, -2))).tolist()
            if abs(r[0]) > 0.05 or abs(r[1]) > 0.05:
                return False
        four_dof = bool(cfg.inertial) and bool(tracker.imu_ready)
        # the correction moves the whole map: drop a running global BA
        tracker._gba_job = None
        past = self.past_loop_edges[-MAX_PAST_LOOP_EDGES:]
        pi = np.zeros(MAX_PAST_LOOP_EDGES, np.int32)
        pj = np.zeros(MAX_PAST_LOOP_EDGES, np.int32)
        pok = np.zeros(MAX_PAST_LOOP_EDGES, bool)
        for n_e, (a, b) in enumerate(past):
            pi[n_e], pj[n_e], pok[n_e] = a, b, True
        dev = tracker.device
        with record_function("correct_loop"):
            tracker.m, _ = correct_loop(
                m, kf_id, cand, s, R, t, four_dof=four_dof,
                past_i=torch.from_numpy(pi).to(dev),
                past_j=torch.from_numpy(pj).to(dev),
                past_ok=torch.from_numpy(pok).to(dev))
        self.past_loop_edges.append((kf_id, cand))
        tracker.m = search_and_fuse(tracker.m, kf_id, cand, tracker.cam,
                                    cfg)
        lm_cfg = cfg.lm_cfg
        if bool(getattr(tracker, "imu_ready", False)) and \
                tracker.kf_imu is not None:
            # an inertial map refines with the synchronous full inertial BA
            tracker.m, _ = local_mapping.full_inertial_ba(
                tracker.m, tracker.kf_imu, kf_id, lm_cfg, window=32,
                prior_gyro=1.0, prior_acc=1.0)
        else:
            # the detached global BA; its first two slices polish the weld
            # before the next local BA, the rest run one per insert
            tracker._gba_job = global_ba.GBAJob(tracker.m, lm_cfg)
            tracker._gba_job.advance()
            tracker._gba_job.advance()
            tracker.m = tracker._gba_job.reconcile(tracker.m)
        tracker.R_last = tracker.m.kf_R[kf_id]
        tracker.t_last = tracker.m.kf_t[kf_id]
        tracker.has_vel = False
        self.last_loop_kf = seq
        self._reset_pending()
        return True

    @record_function("maybe_merge")
    def maybe_merge(self, tracker, kf_id: int, bow) -> bool:
        """Query every unmerged stashed map's database with the new
        keyframe; on a verified Sim(3) weld the stashed map into the active
        one, fuse around the weld and refine with a weld-window BA. True
        when a merge happened."""
        if not tracker.stash or tracker.n_kf_host < 5:
            return False
        m = tracker.m
        cfg = self.cfg
        dev = tracker.device
        n_kf, n_lm = (int(v) for v in torch.stack([m.n_kf, m.n_lm]).tolist())
        for st in tracker.stash:
            if st.merged_into_gen >= 0:
                continue
            if n_kf + st.n_kf > m.kf_valid.shape[0] or \
                    n_lm + int(st.m.n_lm) > m.lm_valid.shape[0]:
                continue
            ids, _, ok = kfdb.top_candidates_grouped(
                st.db, bow, 3, ms.covisibility_matrix(st.m),
                exclude=~st.m.kf_valid, min_score=0.15)
            fix_scale = _fix_scale(tracker, cfg)
            # every verified candidate: the best welds, the others become
            # measured contact edges of an essential-graph pass
            verified = []
            ids_h, ok_h = torch.stack([ids, ok.to(ids.dtype)]).tolist()
            for c, good in zip(ids_h, ok_h):
                if not good:
                    continue
                s_c, R_c, t_c, n_inl = verify_merge(
                    m, kf_id, st.m, c, cfg, fix_scale=fix_scale,
                    generator=tracker.generator)
                n_inl = int(n_inl)
                if n_inl >= MIN_SIM3_INLIERS:
                    verified.append((n_inl, c, s_c, R_c, t_c))
            if not verified:
                continue
            tracker._gba_job = None
            verified.sort(key=lambda v: -v[0])
            _, c_best, s, R, t = verified[0]
            sw, Rw, tw = atlas_mod.sim3_from_cam_pair(
                s, R, t, m.kf_R[kf_id], m.kf_t[kf_id], st.m.kf_R[c_best],
                st.m.kf_t[c_best])
            merged, kf_off, _ = atlas_mod.merge_maps(m, st.m, sw, Rw, tw)
            kf_off = int(kf_off)
            st.merged_into_gen = tracker.map_gen
            st.kf_offset = kf_off
            if tracker.kf_imu is not None and st.kf_imu is not None:
                from ..optim import inertial as inertial_mod
                tracker.kf_imu = inertial_mod.splice_kf_imu(
                    tracker.kf_imu, st.kf_imu, kf_off, st.n_kf)
            # the next keyframe chains to kf_id, not to the welded block
            tracker._kf_prev_override = kf_id
            if tracker.db is not None:
                n_copy = min(st.n_kf, tracker.db.bow.shape[0] - kf_off)
                rows = torch.arange(kf_off, kf_off + n_copy, device=dev)
                tracker.db = kfdb.KeyframeDatabase(
                    bow=put(tracker.db.bow, rows, st.db.bow[:n_copy]),
                    valid=put(tracker.db.valid, rows, st.db.valid[:n_copy]))
            merged = local_mapping.fuse_in_neighbors(merged, kf_id,
                                                     tracker.cam, cfg.lm_cfg)
            merged = ms.update_landmark_stats(merged)
            if len(verified) > 1:
                E = len(verified) - 1
                ei = np.full(E, kf_id, np.int32)
                ej = np.array([v[1] + kf_off for v in verified[1:]],
                              np.int32)
                merged, _ = correct_loop(
                    merged, kf_id, c_best + kf_off, s, R, t,
                    four_dof=bool(getattr(tracker, "imu_ready", False)),
                    extra_i=torch.from_numpy(ei).to(dev),
                    extra_j=torch.from_numpy(ej).to(dev),
                    extra_s=torch.stack([v[2].reshape(()) for v in
                                         verified[1:]]),
                    extra_R=torch.stack([v[3] for v in verified[1:]]),
                    extra_t=torch.stack([v[4] for v in verified[1:]]),
                    extra_ok=torch.ones(E, dtype=torch.bool, device=dev))
            if bool(getattr(tracker, "imu_ready", False)) and \
                    tracker.kf_imu is not None:
                merged = local_mapping.local_inertial_ba(
                    merged, tracker.kf_imu, kf_id, cfg.lm_cfg)
            else:
                merged = local_mapping.local_bundle_adjustment(
                    merged, kf_id, cfg.lm_cfg)
            tracker.m = merged
            tracker.n_kf_host = int(merged.n_kf)
            tracker._free_kf_slots = []
            tracker.R_last = merged.kf_R[kf_id]
            tracker.t_last = merged.kf_t[kf_id]
            tracker.has_vel = False
            self.last_loop_kf = tracker.kf_seq
            return True
        return False
