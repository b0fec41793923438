"""The plain K12 as it stood before `dual.jvp`: the 30-dim robust
Gauss-Newton of `morb_slam_tpu_torch/optim/vi_ba.py`
optimize_pose_inertial_plain with the edge Jacobian from
`torch.func.jacfwd`, copied as the reference that the port's form is held
to bit for bit (`tests/test_torch_pose_inertial_anchor.py`,
`tests/k12_scenario_bitwise.py`). Imports torch and the port only."""
import torch
from torch.func import jacfwd

from morb_slam_tpu_torch import lie
from morb_slam_tpu_torch.optim import ba, linalg, vi_ba


def optimize_pose_inertial_jacfwd(R0_cw, t0_cw, v0, bias0, Xw, obs, info,
                                  valid, obs_ur, baseline, R_a_wb, p_a, v_a,
                                  bias_a, e_dt, e_dR, e_dV, e_dP, e_JRg,
                                  e_JVg, e_JVa, e_JPg, e_JPa, e_info,
                                  e_bias0, e_rw_info, n_iters: int = 10):
    """30-dim robust Gauss-Newton over (anchor keyframe state, current
    state) with the anchor fixed: the current frame's visual terms, the
    inertial edge anchor -> current and the bias random walk; 2 rounds of
    `n_iters` steps, each followed by a chi2 reclassification, then the
    final Hessian. Returns the current frame's camera pose, velocity, bias,
    inliers and the (15, 15) marginal information."""
    f32, dev = t0_cw.dtype, t0_cw.device
    n = Xw.shape[0]
    chi2_th = torch.where(torch.isfinite(obs_ur), vi_ba.HUBER2_STEREO,
                          vi_ba.HUBER2_MONO).to(f32)
    eye30 = torch.eye(30, dtype=f32, device=dev)
    g = vi_ba.gravity(t0_cw)
    z30 = torch.zeros(30, dtype=f32, device=dev)
    tail = (e_dt, e_dR, e_dV, e_dP, e_JRg, e_JVg, e_JVa, e_JPg, e_JPa,
            e_bias0)
    mask = torch.cat([torch.zeros(15, dtype=f32, device=dev),
                      torch.ones(15, dtype=f32, device=dev)])
    # the frame's observations as a one-keyframe BA problem (K4's terms)
    frame = ba.BAProblem(
        R=R0_cw[None], t=t0_cw[None], X=Xw,
        obs_kf=torch.zeros(n, dtype=torch.int32, device=dev),
        obs_lm=torch.arange(n, dtype=torch.int32, device=dev), obs_uv=obs,
        obs_ur=obs_ur, obs_info=info, obs_mask=valid,
        kf_opt=torch.ones(1, dtype=torch.bool, device=dev),
        lm_opt=torch.zeros(n, dtype=torch.bool, device=dev),
        baseline=baseline)

    def gn_step(Ra, pa, va, ba_, R_wb, p_wb, v, bias, active):
        R_cw, t_cw = lie.se3_inv(R_wb, p_wb)
        r, Jp, _, w, chi2 = ba._obs_terms(frame._replace(obs_mask=active),
                                          R_cw[None], t_cw[None], Xw,
                                          body=True)
        Hv = torch.einsum('nia,n,nib->ab', Jp, w, Jp)
        gv = -torch.einsum('nia,n,ni->a', Jp, w, r)

        def f(x):
            return vi_ba._edge_residual(x, Ra, pa, va, ba_, R_wb, p_wb, v,
                                        *tail, g)
        re = f(z30)
        Je = jacfwd(f)(z30).to(f32)                          # (9, 30)
        JtW = torch.einsum('ai,ab->bi', Je, e_info)
        H = torch.einsum('bi,bj->ij', JtW, Je)
        gg = -torch.einsum('bi,b->i', JtW, re)
        H[15:21, 15:21] += Hv
        gg[15:21] += gv
        r_rw = bias - ba_
        drw = torch.diag(e_rw_info)
        H[9:15, 9:15] += drw
        H[24:30, 24:30] += drw
        H[9:15, 24:30] -= drw
        H[24:30, 9:15] -= drw
        gg[9:15] += e_rw_info * r_rw
        gg[24:30] += -e_rw_info * r_rw
        H = H * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
        gg = gg * mask
        H = 0.5 * (H + H.T)
        d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-8))
        Hs = H / d[:, None] / d[None, :] + 1e-6 * eye30
        dx = linalg.solve_spd(Hs, gg / d) / d
        xi, xj = dx[:15], dx[15:]
        new = (lie.matmat(Ra, lie.so3_exp(xi[3:6])),
               pa + lie.matvec(Ra, xi[0:3]), va + xi[6:9], ba_ + xi[9:15],
               lie.matmat(R_wb, lie.so3_exp(xj[3:6])),
               p_wb + lie.matvec(R_wb, xj[0:3]), v + xj[6:9],
               bias + xj[9:15])
        return new, chi2, H

    def obs_chi2(R_wb, p_wb, active):
        # gn_step's chi2 without its edge Jacobian and solve
        R_cw, t_cw = lie.se3_inv(R_wb, p_wb)
        return ba._obs_terms(frame._replace(obs_mask=active), R_cw[None],
                             t_cw[None], Xw, body=True)[4]

    st = (R_a_wb, p_a, v_a, bias_a, *lie.se3_inv(R0_cw, t0_cw), v0, bias0)
    active = valid
    for _ in range(2):
        for _ in range(n_iters):
            st, _, _ = gn_step(*st, active)
        active = valid & (obs_chi2(st[4], st[5], active) < chi2_th)
    _, chi2, H_full = gn_step(*st, active)
    inl = valid & (chi2 < chi2_th)
    R_cw, t_cw = lie.se3_inv(*st[4:6])
    return vi_ba.PoseInertialResult(R_cw=R_cw, t_cw=t_cw, v=st[6],
                                    bias=st[7],
                                    inliers=inl,
                                    n_inliers=torch.sum(inl),
                                    H_marg=vi_ba._marginal(H_full))
