"""K13's one-call form on the CPU: `vi_ba.inertial_terms` (the inertial
system and cost at one state) is its plain composition there, and the
restructured `vi_ba_solve` (one `inertial_terms` call at the start state
and one at each candidate, the accepted candidate's system kept for the
next step) gives bit for bit the iterates, costs and accept decisions of
the earlier loop, which asked for the system at the current state in every
step and for the cost at every candidate; a copy of that loop is kept
here. On the CPU the solve computes no system that no step uses: n systems
and n + 1 costs for n iterations, as the earlier loop did."""
import numpy as np
import pytest
import torch

from morb_slam_tpu_torch import lie
from morb_slam_tpu_torch.optim import ba, linalg, vi_ba

from test_torch_vi_ba import _port
from test_vi_ba import make_problem

torch.set_num_threads(1)


def _problem(case):
    """test_vi_ba.py's window at W = 6 with 48 landmarks: poses and
    velocities perturbed, or a bias off its preintegration point."""
    if case == "bias":
        prob, _ = make_problem(W=6, n_lm=48, noise_pose=0.01, seed=2,
                               bias_init=np.array([0.002, -0.001, 0.003,
                                                   0.02, 0.01, -0.02]))
    else:
        prob, _ = make_problem(W=6, n_lm=48, noise_pose=0.03, noise_v=0.1,
                               seed=5, px_noise=1.0)
    return _port(prob)


def _earlier_lm_step(p, R_wb, p_wb, v, bias, X, lam, vis):
    """The earlier `vi_ba._lm_step`: the inertial system asked for at the
    current state, the landmark Schur term subtracted in place."""
    W = p.R_wb.shape[0]
    L = p.X.shape[0]
    D = 15 * W
    f32, dev = p.p_wb.dtype, p.p_wb.device
    lm_opt_f = p.lm_opt.to(f32)
    eyeL = torch.eye(3, dtype=f32, device=dev)
    free = vi_ba._free_mask(p)
    ks = torch.arange(W, device=dev)
    H, b = vi_ba.inertial_system_plain(p, R_wb, p_wb, v, bias, vis.Hpp,
                                       vis.bp)
    Hll_d = vis.Hll + lam * eyeL * torch.clamp(
        torch.diagonal(vis.Hll, dim1=-2, dim2=-1), min=1e-6)[..., None] * eyeL
    Hll_d = torch.where(p.lm_opt[:, None, None], Hll_d,
                        eyeL.expand(Hll_d.shape))
    bl_m = vis.bl * lm_opt_f[:, None]
    Hll_inv = linalg.inv3x3(Hll_d)
    B = vis.Bt.permute(1, 2, 0, 3).reshape(W * 6, L, 3)
    BC = torch.einsum('mlb,lbc->mlc', B, Hll_inv)
    S_off = BC.reshape(W * 6, L * 3) @ B.reshape(W * 6, L * 3).T
    rhs_off = BC.reshape(W * 6, L * 3) @ bl_m.reshape(L * 3)
    pose_idx = (ks[:, None] * 15 + torch.arange(6, device=dev)[None]
                ).reshape(-1)
    H[pose_idx[:, None], pose_idx[None, :]] -= S_off
    b[pose_idx] -= rhs_off
    H = 0.5 * (H + H.T)
    d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-8))
    d = torch.where(free > 0, d, torch.ones_like(d))
    Hs = H / d[:, None] / d[None, :] + lam * torch.eye(D, dtype=f32,
                                                         device=dev)
    Hs = Hs * free[:, None] * free[None, :] + torch.diag(1.0 - free)
    bs = (b / d) * free
    dx = (linalg.solve_spd(Hs, bs) / d).reshape(W, 15) * free.reshape(W, 15)
    Btdxp = torch.einsum('mlc,m->lc', B, dx[:, 0:6].reshape(-1))
    dxl = torch.einsum('lab,lb->la', Hll_inv, bl_m - Btdxp) * \
        lm_opt_f[:, None]
    return (lie.matmat(R_wb, lie.so3_exp(dx[:, 3:6])),
            p_wb + lie.matvec(R_wb, dx[:, 0:3]), v + dx[:, 6:9],
            bias + dx[:, 9:15], X + dxl)


def _earlier_solve(p, n_iters, lambda0=1e-3):
    """The earlier `vi_ba.vi_ba_solve` loop, its accept decisions kept."""
    f32, dev = p.p_wb.dtype, p.p_wb.device
    bap = vi_ba._ba_problem(p)

    def visual(R_wb, p_wb, X):
        R_cw, t_cw = lie.se3_inv(R_wb, p_wb)
        return ba.assemble(bap, R_cw, t_cw, X, None, body=True)

    def total_cost(vis, R_wb, p_wb, v, bias):
        return vis.cost + vi_ba.inertial_cost_plain(p, R_wb, p_wb, v, bias)

    state = (p.R_wb, p.p_wb, p.v, p.bias, p.X)
    vis = visual(p.R_wb, p.p_wb, p.X)
    cost0 = cost = total_cost(vis, *state[:4])
    lam = torch.tensor(lambda0, dtype=f32, device=dev)
    costs, accepted = [], []
    for _ in range(n_iters):
        out = _earlier_lm_step(p, *state, lam, vis)
        vis_c = visual(out[0], out[1], out[4])
        new_cost = total_cost(vis_c, *out[:4])
        ok = torch.isfinite(new_cost) & (new_cost < cost)
        state = tuple(torch.where(ok, n, o) for n, o in zip(out, state))
        vis = ba._where(ok, vis_c, vis)
        cost = torch.where(ok, new_cost, cost)
        lam = torch.clamp(torch.where(ok, lam * 0.5, lam * 8.0), 1e-9, 1e7)
        costs.append(cost)
        accepted.append(ok)
    return (*state, {"cost0": cost0, "costs": torch.stack(costs),
                     "accepted": torch.stack(accepted)})


@pytest.mark.parametrize("case,n_iters", [("perturbed", 4), ("bias", 3)])
def test_vi_ba_solve_bitwise_equals_earlier_loop(case, n_iters,
                                                 monkeypatch):
    p = _problem(case)
    calls = {"system": 0, "cost": 0}
    sys_plain, cost_plain = vi_ba.inertial_system_plain, \
        vi_ba.inertial_cost_plain

    def count(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(vi_ba, "inertial_system_plain",
                        count("system", sys_plain))
    monkeypatch.setattr(vi_ba, "inertial_cost_plain",
                        count("cost", cost_plain))
    before = dict(vi_ba.INERTIAL_LAUNCHES)
    got = vi_ba.vi_ba_solve(p, n_iters=n_iters)
    assert calls == {"system": n_iters, "cost": n_iters + 1}
    assert vi_ba.INERTIAL_LAUNCHES["plain"] - before["plain"] == n_iters + 1
    assert vi_ba.INERTIAL_LAUNCHES["kernel"] == before["kernel"]
    want = _earlier_solve(p, n_iters)
    assert calls == {"system": 2 * n_iters, "cost": 2 * n_iters + 2}
    for a, b in zip(got[:5], want[:5]):
        assert torch.equal(a, b)
    for key in ("cost0", "costs", "accepted"):
        assert torch.equal(got[5][key], want[5][key]), key
    # the loop moved: some step was accepted and the cost fell
    assert bool(got[5]["accepted"].any())
    assert float(got[5]["costs"][-1]) < float(got[5]["cost0"])


def test_inertial_terms_cpu_is_the_plain_composition():
    p = _problem("perturbed")
    st = (p.R_wb, p.p_wb, p.v, p.bias)
    W = p.R_wb.shape[0]
    g = torch.Generator().manual_seed(1)
    A = torch.randn(W, 6, 6, generator=g)
    Hpp, bp = A @ A.transpose(1, 2) * 1e4, torch.randn(W, 6, generator=g)
    H, b, c = vi_ba.inertial_terms(p, *st, Hpp, bp)
    H0, b0 = vi_ba.inertial_system_plain(p, *st, Hpp, bp)
    assert torch.equal(H, H0) and torch.equal(b, b0)
    assert torch.equal(c, vi_ba.inertial_cost_plain(p, *st))
    assert H.shape == (15 * W, 15 * W) and b.shape == (15 * W,)
    none_h, none_b, c2 = vi_ba.inertial_terms(p, *st, Hpp, bp, system=False)
    assert none_h is None and none_b is None and torch.equal(c, c2)
