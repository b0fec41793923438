// The 9-dof inertial edge residual of optim/vi_ba.py:_edge_residual on
// dual numbers (K13, vi_edges.cu) and its constants (K13 and K12,
// pose_inertial.cu, which keeps its own form with the anchor fixed).
#pragma once
#include "dual.cuh"

// One edge's preintegration constants (optim/vi_ba.py VIBAProblem e_*).
struct ImuEdge {
    float dt;
    const float *dR, *dV, *dP, *JRg, *JVg, *JVa, *JPg, *JPa, *bias0;
};

// vi_ba._edge_residual at the zero perturbation with tangent e_lane
// (lane < 30; any other lane gives the values with zero derivatives):
// r (value, derivative) for the 9 residuals. Si, Sj are the body states
// [R 0, p 9, v 12, b 15] of the edge's two keyframes.
__device__ void edge_residual(int lane, const float* Si, const float* Sj,
                              const ImuEdge& C, Dl* r) {
    Dl x[30];
    for (int q = 0; q < 30; ++q) x[q] = Dl{0.0f, q == lane ? 1.0f : 0.0f};
    Dl Ri[9], Rj[9], E[9], Ri_[9], Rj_[9], t3[3];
    for (int k = 0; k < 9; ++k) {
        Ri[k] = dl(Si[k]);
        Rj[k] = dl(Sj[k]);
    }
    dexp(x + 3, E);
    dmm(Ri, E, Ri_);
    dexp(x + 18, E);
    dmm(Rj, E, Rj_);
    Dl pi_[3], vi_[3], pj_[3], vj_[3], dbg[3], dba[3];
    dmv(Ri, x + 0, t3);
    for (int q = 0; q < 3; ++q) pi_[q] = dl(Si[9 + q]) + t3[q];
    dmv(Rj, x + 15, t3);
    for (int q = 0; q < 3; ++q) pj_[q] = dl(Sj[9 + q]) + t3[q];
    for (int q = 0; q < 3; ++q) {
        vi_[q] = dl(Si[12 + q]) + x[6 + q];
        vj_[q] = dl(Sj[12 + q]) + x[21 + q];
        dbg[q] = (dl(Si[15 + q]) + x[9 + q]) - dl(C.bias0[q]);
        dba[q] = (dl(Si[18 + q]) + x[12 + q]) - dl(C.bias0[3 + q]);
    }
    Dl J[9], u[3], w[3], dR[9], dRc[9];
    for (int k = 0; k < 9; ++k) {
        J[k] = dl(C.JRg[k]);
        dR[k] = dl(C.dR[k]);
    }
    dmv(J, dbg, u);
    dexp(u, E);
    dmm(dR, E, dRc);
    Dl dVc[3], dPc[3];
    for (int q = 0; q < 3; ++q) {
        dVc[q] = dl(C.dV[q]);
        dPc[q] = dl(C.dP[q]);
    }
    const float* Js[4] = {C.JVg, C.JVa, C.JPg, C.JPa};
    for (int m = 0; m < 4; ++m) {
        for (int k = 0; k < 9; ++k) J[k] = dl(Js[m][k]);
        dmv(J, (m % 2 == 0) ? dbg : dba, u);
        for (int q = 0; q < 3; ++q) {
            if (m < 2) dVc[q] = dVc[q] + u[q];
            else dPc[q] = dPc[q] + u[q];
        }
    }
    Dl RiT[9], M1[9], dRcT[9], M2[9];
    dT(Ri_, RiT);
    dmm(RiT, Rj_, M1);
    dT(dRc, dRcT);
    dmm(dRcT, M1, M2);
    dlog(M2, r);
    const float dt = C.dt;
    const float g[3] = {0.0f, 0.0f, -9.81f};
    Dl a[3], b[3];
    for (int q = 0; q < 3; ++q) {
        a[q] = vj_[q] - vi_[q] - dl(g[q] * dt);
        b[q] = pj_[q] - pi_[q] - dt * vi_[q] - dl(0.5f * g[q] * dt * dt);
    }
    dmv(RiT, a, u);
    dmv(RiT, b, w);
    for (int q = 0; q < 3; ++q) {
        r[3 + q] = u[q] - dVc[q];
        r[6 + q] = w[q] - dPc[q];
    }
}
