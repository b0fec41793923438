// K17: the Gauss-Newton system of the IMU initialization (gravity
// direction, scale, biases and one velocity per keyframe slot, poses
// fixed): H, g and the cost at one point.
//
// Replaces, in morb_slam_tpu/optim/inertial.py:inertial_only_optimize, the
// residuals' jax.jacfwd over all 9 + 3K parameters and the normal
// equations built from it (gn_step, :356-379), and cost_of (:351). The
// plain version is optim/inertial.py:inertial_system_plain; the damping,
// the dense solve and the accept test stay PyTorch on the device.
//
// What bounds it on an H100: bytes, barely. One system reads ~0.65 KB of
// constants and poses per keyframe slot and writes the dense (9 + 3K)^2
// H: 2.4 MB at K = 256 slots, ~0.7 us at 3.35 TB/s. Each live edge's 15
// Jacobian columns are ~30 kflop of dual-number arithmetic. The reference
// program differentiates every residual along all 777 parameters (a
// (K, 9, 777) Jacobian) and contracts it densely.
//
// Design: two launches, no float atomics.
//  - Edges: one warp per keyframe slot k (the edge prev(k) -> k). Lane
//    d < 15 evaluates the edge's residual on dual numbers seeded with the
//    unit tangent of its d-th local parameter [phi_g (2), log s, bg, ba,
//    v_prev, v_k] (dual.cuh), giving column d of its 9 x 15 Jacobian in
//    shared memory; the warp forms w J^T Omega J (15 x 15), w J^T Omega r
//    (15) and w r^T Omega r and writes them to scratch. A slot of weight
//    0 writes zeros.
//  - Assembly: one thread per entry of H and of g, and one for the cost,
//    each summing its edges' terms in slot order: the globals' rows over
//    every slot, a velocity block over the slots whose edge touches it
//    (an off-diagonal block only the two edges that link its slots), then
//    the bias priors. Every entry is written; two launches give the same
//    bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dual.cuh"

// per-slot constants, packed by optim/inertial.py:init_problem
#define C_DT 0
#define C_DR 1
#define C_DV 10
#define C_DP 13
#define C_JRG 16
#define C_JVG 25
#define C_JVA 34
#define C_JPG 43
#define C_JPA 52
#define C_BIAS0 61
#define C_INFO 67
#define C_W 148
#define N_C 149
#define G_ACC 9.81f

__device__ __forceinline__ Dl dexp1(Dl a) {
    const float e = expf(a.v);
    return Dl{e, e * a.d};
}

// optim/inertial.py:_edge_residuals for one slot at the local parameters
// (x's globals, v_prev, v_k) with tangent e_lane (lane >= 15: values only)
__device__ void init_residual(int lane, const float* x, const float* vp,
                              const float* vk, const float* C,
                              const float* Ri, const float* Rj,
                              const float* pi, const float* pj,
                              const float* base, int opt_scale, Dl* r) {
    Dl xl[15];
    for (int q = 0; q < 15; ++q) {
        const float v = q < 9 ? x[q] : (q < 12 ? vp[q - 9] : vk[q - 12]);
        xl[q] = Dl{v, q == lane ? 1.0f : 0.0f};
    }
    const Dl phi[3] = {xl[0], xl[1], dl(0.0f)};
    Dl E[9], B[9], Rwg[9], g[3];
    dexp(phi, E);
    for (int k = 0; k < 9; ++k) B[k] = dl(base[k]);
    dmm(E, B, Rwg);
    for (int i = 0; i < 3; ++i) g[i] = Rwg[3 * i + 2] * dl(-G_ACC);
    const Dl s = opt_scale ? dexp1(xl[2]) : dl(1.0f);
    Dl dbg[3], dba[3], u[3], J[9], dR[9], dRc[9], dVc[3], dPc[3];
    for (int q = 0; q < 3; ++q) {
        dbg[q] = xl[3 + q] - dl(C[C_BIAS0 + q]);
        dba[q] = xl[6 + q] - dl(C[C_BIAS0 + 3 + q]);
        dVc[q] = dl(C[C_DV + q]);
        dPc[q] = dl(C[C_DP + q]);
    }
    for (int k = 0; k < 9; ++k) {
        J[k] = dl(C[C_JRG + k]);
        dR[k] = dl(C[C_DR + k]);
    }
    dmv(J, dbg, u);
    dexp(u, E);
    dmm(dR, E, dRc);
    const int offs[4] = {C_JVG, C_JVA, C_JPG, C_JPA};
    for (int m = 0; m < 4; ++m) {
        for (int k = 0; k < 9; ++k) J[k] = dl(C[offs[m] + k]);
        dmv(J, (m % 2 == 0) ? dbg : dba, u);
        for (int q = 0; q < 3; ++q) {
            if (m < 2) dVc[q] = dVc[q] + u[q];
            else dPc[q] = dPc[q] + u[q];
        }
    }
    Dl RiT[9], M1[9], dRcT[9], M2[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            float m = 0.0f;
            for (int k = 0; k < 3; ++k) m += Ri[3 * k + i] * Rj[3 * k + j];
            M1[3 * i + j] = dl(m);
            RiT[3 * i + j] = dl(Ri[3 * j + i]);
        }
    dT(dRc, dRcT);
    dmm(dRcT, M1, M2);
    dlog(M2, r);
    const float dt = C[C_DT];
    Dl a[3], b[3], ra[3], rb[3];
    for (int q = 0; q < 3; ++q) {
        a[q] = xl[12 + q] - xl[9 + q] - g[q] * dl(dt);
        b[q] = dl(pj[q]) * s - dl(pi[q]) * s - xl[9 + q] * dl(dt) -
               (0.5f * g[q]) * dl(dt * dt);
    }
    dmv(RiT, a, ra);
    dmv(RiT, b, rb);
    for (int q = 0; q < 3; ++q) {
        r[3 + q] = ra[q] - dVc[q];
        r[6 + q] = rb[q] - dPc[q];
    }
}

__global__ void __launch_bounds__(32)
init_edge_kernel(const float* __restrict__ cst, const float* __restrict__ Rwb,
                 const float* __restrict__ pwb, const float* __restrict__ x,
                 const float* __restrict__ base, const int* __restrict__ prev,
                 int opt_scale, float* __restrict__ He,
                 float* __restrict__ ge, float* __restrict__ ce) {
    __shared__ float C[N_C];
    __shared__ float Je[9][15], JtW[9][15], re[9];
    const int e = blockIdx.x, lane = threadIdx.x;
    for (int q = lane; q < N_C; q += 32) C[q] = cst[(size_t)e * N_C + q];
    __syncwarp();
    const float w = C[C_W];
    float* he = He + (size_t)e * 225;
    float* g = ge + (size_t)e * 15;
    if (w == 0.0f) {
        for (int q = lane; q < 225; q += 32) he[q] = 0.0f;
        if (lane < 15) g[lane] = 0.0f;
        if (lane == 0) ce[e] = 0.0f;
        return;
    }
    const int p = max(prev[e], 0);
    if (lane < 15) {
        Dl r[9];
        init_residual(lane, x, x + 9 + 3 * p, x + 9 + 3 * e, C,
                      Rwb + 9 * (size_t)p, Rwb + 9 * (size_t)e,
                      pwb + 3 * (size_t)p, pwb + 3 * (size_t)e, base,
                      opt_scale, r);
        for (int a = 0; a < 9; ++a) Je[a][lane] = r[a].d;
        if (lane == 0)
            for (int a = 0; a < 9; ++a) re[a] = r[a].v;
    }
    __syncwarp();
    // JtW[b][i] = sum_a Je[a][i] Omega[a][b]
    for (int q = lane; q < 135; q += 32) {
        const int b = q / 15, i = q % 15;
        float s = 0.0f;
        for (int a = 0; a < 9; ++a) s += Je[a][i] * C[C_INFO + 9 * a + b];
        JtW[b][i] = s;
    }
    __syncwarp();
    for (int q = lane; q < 225; q += 32) {
        const int i = q / 15, j = q % 15;
        float s = 0.0f;
        for (int b = 0; b < 9; ++b) s += JtW[b][i] * Je[b][j];
        he[q] = w * s;
    }
    if (lane < 15) {
        float s = 0.0f;
        for (int b = 0; b < 9; ++b) s += JtW[b][lane] * re[b];
        g[lane] = w * s;
    }
    if (lane == 0) {
        float c = 0.0f;
        for (int i = 0; i < 9; ++i) {
            float s = 0.0f;
            for (int j = 0; j < 9; ++j) s += C[C_INFO + 9 * i + j] * re[j];
            c += re[i] * s;
        }
        ce[e] = w * c;
    }
}

// one edge's term of H at global rows / columns (ri, ci): the sum over the
// local places each parameter takes in that edge (a velocity slot may be
// both its v_prev and its v_k)
__device__ __forceinline__ float edge_term(const float* he, int e, int p,
                                           int r, int c) {
    int lr[2], lc[2], nr = 0, nc = 0;
    if (r < 9) lr[nr++] = r;
    else {
        const int I = (r - 9) / 3, a = (r - 9) % 3;
        if (p == I) lr[nr++] = 9 + a;
        if (e == I) lr[nr++] = 12 + a;
    }
    if (c < 9) lc[nc++] = c;
    else {
        const int J = (c - 9) / 3, b = (c - 9) % 3;
        if (p == J) lc[nc++] = 9 + b;
        if (e == J) lc[nc++] = 12 + b;
    }
    float s = 0.0f;
    for (int i = 0; i < nr; ++i)
        for (int j = 0; j < nc; ++j) s += he[lr[i] * 15 + lc[j]];
    return s;
}

__global__ void init_assemble_kernel(int K, const float* __restrict__ He,
                                     const float* __restrict__ ge,
                                     const float* __restrict__ ce,
                                     const int* __restrict__ prev,
                                     const float* __restrict__ x,
                                     float prior_gyro, float prior_acc,
                                     float* __restrict__ H,
                                     float* __restrict__ g,
                                     float* __restrict__ cost) {
    const int n = 9 + 3 * K;
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long nH = (long long)n * n;
    const float prior[9] = {0.0f,       0.0f,       0.0f,
                            prior_gyro, prior_gyro, prior_gyro,
                            prior_acc,  prior_acc,  prior_acc};
    if (idx < nH) {
        const int r = (int)(idx / n), c = (int)(idx % n);
        float s = 0.0f;
        if (r >= 9 && c >= 9 && (r - 9) / 3 != (c - 9) / 3) {
            // two slots: only the edges from one to the other
            const int I = (r - 9) / 3, J = (c - 9) / 3;
            for (int t = 0; t < 2; ++t) {
                const int e = t == 0 ? min(I, J) : max(I, J);
                const int p = max(prev[e], 0);
                s += edge_term(He + (size_t)e * 225, e, p, r, c);
            }
        } else {
            for (int e = 0; e < K; ++e)
                s += edge_term(He + (size_t)e * 225, e, max(prev[e], 0), r, c);
        }
        if (r == c && r < 9) s += prior[r];
        H[idx] = s;
        return;
    }
    if (idx < nH + n) {
        const int r = (int)(idx - nH);
        float s = 0.0f;
        for (int e = 0; e < K; ++e) {
            const float* gg = ge + (size_t)e * 15;
            if (r < 9) {
                s += gg[r];
                continue;
            }
            const int I = (r - 9) / 3, a = (r - 9) % 3;
            if (max(prev[e], 0) == I) s += gg[9 + a];
            if (e == I) s += gg[12 + a];
        }
        if (r < 9) s += prior[r] * x[r];
        g[r] = s;
        return;
    }
    if (idx != nH + n) return;
    float s = 0.0f;
    for (int e = 0; e < K; ++e) s += ce[e];
    for (int q = 3; q < 9; ++q) s += prior[q] * x[q] * x[q];
    cost[0] = s;
}

extern "C" int inertial_init_system(const void* cst, const void* Rwb,
                                    const void* pwb, const void* x,
                                    const void* base, const void* prev,
                                    int K, int opt_scale, float prior_gyro,
                                    float prior_acc, void* He, void* ge,
                                    void* ce, void* H, void* g, void* cost,
                                    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    init_edge_kernel<<<K, 32, 0, s>>>(
        (const float*)cst, (const float*)Rwb, (const float*)pwb,
        (const float*)x, (const float*)base, (const int*)prev, opt_scale,
        (float*)He, (float*)ge, (float*)ce);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    const long long n = 9 + 3LL * K;
    const int threads = 256;
    const long long blocks = (n * n + n + 1 + threads - 1) / threads;
    init_assemble_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        K, (const float*)He, (const float*)ge, (const float*)ce,
        (const int*)prev, (const float*)x, prior_gyro, prior_acc, (float*)H,
        (float*)g, (float*)cost);
    return (int)cudaGetLastError();
}
