// K13: the inertial part of one Levenberg-Marquardt step of the visual-
// inertial window BA, and the inertial cost of its accept test.
//
// Replaces, in morb_slam_tpu/optim/vi_ba.py, `_edge_terms` (:196: the 9-dof
// residual `_edge_residual` and its 9 x 30 Jacobian at zero tangent by
// vmap(jacfwd)), the per-edge J^T Omega J and gradient scattered into the
// dense (15W)^2 system of `_lm_step` (:278-302), the bias random walk
// (:304-313) and the bias priors (:315-321); and `_quad_costs` (:217). The
// plain versions are optim/vi_ba.py:inertial_system_plain and
// inertial_cost_plain.
//
// What bounds it on an H100: latency. One step reads ~0.7 KB of state and
// constants per edge and writes the dense system, (15W)^2 floats: 176 KB at
// W = 14, 0.92 MB at W = 32, a few tenths of a microsecond at 3.35 TB/s.
// Each edge's Jacobian is ~45 kflop of dual-number arithmetic in one serial
// chain per tangent. The plain version issues several hundred small
// kernels per step; the step's time is the chain of dependent launches.
//
// Design: two launches per system, one per cost, no float atomics.
//  - Edges: one warp per edge (a block of 32 threads each). Lane d < 30
//    evaluates the residual on dual numbers seeded with the unit tangent
//    e_d (imu_edge.cuh, K12's device code), giving column d of Je (9 x 30)
//    in shared memory; the warp then forms J^T Omega (30 x 9), the edge's
//    He = J^T Omega J (30 x 30) and ge = -J^T Omega r (30) and writes them
//    to scratch. An invalid edge (e_valid false; e_prev -1 is clamped to 0)
//    writes zeros, as the plain version's mask does.
//  - Assembly: one thread per entry of H (and one per entry of b) sums, in
//    a fixed order, the visual pose block (K4's Hpp, bp), the ii, ij, ji
//    and jj blocks of every edge whose (prev, e) touches its block, the
//    bias random walk and the bias prior. Every entry is written, so no
//    zero fill runs; two launches give the same bits.
//  - Cost: one warp; lane t sums the edges t, t + 32, ... (residual values
//    only: r^T Omega r, the random walk and the prior), then a fixed xor
//    butterfly reduces the lanes.
// The arithmetic follows the plain version's formulas in float32 (its
// forward mode carries some tangents in float64), so the two agree to
// float32 rounding of the Jacobian.
#include <cuda_runtime.h>
#include <stdint.h>

#include "imu_edge.cuh"

// per-edge constants, packed by optim/vi_ba.py:_edge_consts
#define E_DT 0
#define E_DR 1
#define E_DV 10
#define E_DP 13
#define E_JRG 16
#define E_JVG 25
#define E_JVA 34
#define E_JPG 43
#define E_JPA 52
#define E_INFO 61
#define E_BIAS0 142
#define E_RW 148
#define E_PRIOR 154
#define N_EC 160
// per-slot body state [R 0, p 9, v 12, b 15]
#define N_ST 21

__device__ __forceinline__ ImuEdge edge_of(const float* c) {
    return ImuEdge{c[E_DT],      c + E_DR,    c + E_DV,    c + E_DP,
                   c + E_JRG,    c + E_JVG,   c + E_JVA,   c + E_JPG,
                   c + E_JPA,    c + E_BIAS0};
}

__global__ void __launch_bounds__(32)
vi_edge_kernel(const float* __restrict__ state,
               const float* __restrict__ cst, const int* __restrict__ prev,
               const uint8_t* __restrict__ valid, float* __restrict__ He,
               float* __restrict__ ge) {
    __shared__ float S[2 * N_ST], C[N_EC];
    __shared__ float Je[9][30], JtW[9][30], re[9];
    const int e = blockIdx.x, lane = threadIdx.x;
    const int p = max(prev[e], 0);
    float* he = He + (size_t)e * 900;
    float* g = ge + (size_t)e * 30;
    if (!valid[e]) {
        for (int q = lane; q < 900; q += 32) he[q] = 0.0f;
        if (lane < 30) g[lane] = 0.0f;
        return;
    }
    for (int q = lane; q < N_ST; q += 32) {
        S[q] = state[(size_t)p * N_ST + q];
        S[N_ST + q] = state[(size_t)e * N_ST + q];
    }
    for (int q = lane; q < N_EC; q += 32) C[q] = cst[(size_t)e * N_EC + q];
    __syncwarp();
    if (lane < 30) {
        const ImuEdge E = edge_of(C);
        Dl r[9];
        edge_residual(lane, S, S + N_ST, E, r);
        for (int a = 0; a < 9; ++a) Je[a][lane] = r[a].d;
        if (lane == 0)
            for (int a = 0; a < 9; ++a) re[a] = r[a].v;
    }
    __syncwarp();
    // JtW[b][i] = sum_a Je[a][i] Omega[a][b]
    for (int q = lane; q < 270; q += 32) {
        const int b = q / 30, i = q % 30;
        float s = 0.0f;
        for (int a = 0; a < 9; ++a) s += Je[a][i] * C[E_INFO + 9 * a + b];
        JtW[b][i] = s;
    }
    __syncwarp();
    for (int q = lane; q < 900; q += 32) {
        const int i = q / 30, j = q % 30;
        float s = 0.0f;
        for (int b = 0; b < 9; ++b) s += JtW[b][i] * Je[b][j];
        he[q] = s;
    }
    if (lane < 30) {
        float s = 0.0f;
        for (int b = 0; b < 9; ++b) s += JtW[b][lane] * re[b];
        g[lane] = -s;
    }
}

__global__ void vi_assemble_kernel(int W, const float* __restrict__ He,
                                   const float* __restrict__ ge,
                                   const int* __restrict__ prev,
                                   const uint8_t* __restrict__ valid,
                                   const float* __restrict__ state,
                                   const float* __restrict__ cst,
                                   const float* __restrict__ Hpp,
                                   const float* __restrict__ bp,
                                   float* __restrict__ H,
                                   float* __restrict__ b) {
    const int D = 15 * W;
    const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long nH = (long long)D * D;
    if (idx < nH) {
        const int r = (int)(idx / D), c = (int)(idx % D);
        const int I = r / 15, a = r % 15, J = c / 15, bb = c % 15;
        float s = 0.0f;
        if (I == J && a < 6 && bb < 6) s = Hpp[(size_t)I * 36 + a * 6 + bb];
        for (int e = 0; e < W; ++e) {
            if (!valid[e]) continue;
            const int p = max(prev[e], 0);
            const float* h = He + (size_t)e * 900;
            if (I == p && J == p) s += h[a * 30 + bb];
            if (I == p && J == e) s += h[a * 30 + 15 + bb];
            if (I == e && J == p) s += h[bb * 30 + 15 + a];
            if (I == e && J == e) s += h[(15 + a) * 30 + 15 + bb];
        }
        if (a == bb && a >= 9) {
            for (int e = 0; e < W; ++e) {
                if (!valid[e]) continue;
                const int p = max(prev[e], 0);
                const float rw = cst[(size_t)e * N_EC + E_RW + a - 9];
                if (I == p && J == p) s += rw;
                if (I == e && J == e) s += rw;
                if (I == p && J == e) s -= rw;
                if (I == e && J == p) s -= rw;
            }
            if (I == J) s += cst[(size_t)I * N_EC + E_PRIOR + a - 9];
        }
        H[idx] = s;
        return;
    }
    if (idx >= nH + D) return;
    const int r = (int)(idx - nH);
    const int I = r / 15, a = r % 15;
    float s = a < 6 ? bp[(size_t)I * 6 + a] : 0.0f;
    for (int e = 0; e < W; ++e) {
        if (!valid[e]) continue;
        const int p = max(prev[e], 0);
        if (p == I) s += ge[(size_t)e * 30 + a];
        if (e == I) s += ge[(size_t)e * 30 + 15 + a];
    }
    if (a >= 9) {
        const int k = a - 9;
        for (int e = 0; e < W; ++e) {
            if (!valid[e]) continue;
            const int p = max(prev[e], 0);
            const float rr = state[(size_t)e * N_ST + 15 + k] -
                             state[(size_t)p * N_ST + 15 + k];
            const float rw = cst[(size_t)e * N_EC + E_RW + k];
            if (p == I) s += rw * rr;
            if (e == I) s += -rw * rr;
        }
        s += -cst[(size_t)I * N_EC + E_PRIOR + k] *
             state[(size_t)I * N_ST + 15 + k];
    }
    b[r] = s;
}

__global__ void __launch_bounds__(32)
vi_cost_kernel(int W, const float* __restrict__ state,
               const float* __restrict__ cst, const int* __restrict__ prev,
               const uint8_t* __restrict__ valid, float* __restrict__ out) {
    const int lane = threadIdx.x;
    float acc = 0.0f;
    for (int e = lane; e < W; e += 32) {
        const float* c = cst + (size_t)e * N_EC;
        const float* se = state + (size_t)e * N_ST;
        float ce = 0.0f;
        if (valid[e]) {
            const float* sp = state + (size_t)max(prev[e], 0) * N_ST;
            const ImuEdge E = edge_of(c);
            Dl r[9];
            edge_residual(-1, sp, se, E, r);
            for (int i = 0; i < 9; ++i) {
                float s = 0.0f;
                for (int j = 0; j < 9; ++j) s += c[E_INFO + 9 * i + j] * r[j].v;
                ce += r[i].v * s;
            }
            for (int k = 0; k < 6; ++k) {
                const float rr = se[15 + k] - sp[15 + k];
                ce += rr * rr * c[E_RW + k];
            }
        }
        for (int k = 0; k < 6; ++k) ce += se[15 + k] * se[15 + k] * c[E_PRIOR + k];
        acc += ce;
    }
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out[0] = acc;
}

extern "C" int vi_edges_system(const void* state, const void* cst,
                               const void* prev, const void* valid,
                               const void* Hpp, const void* bp, int W,
                               void* He, void* ge, void* H, void* b,
                               void* stream) {
    if (W == 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    vi_edge_kernel<<<W, 32, 0, s>>>(
        (const float*)state, (const float*)cst, (const int*)prev,
        (const uint8_t*)valid, (float*)He, (float*)ge);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    const long long D = 15LL * W;
    const int threads = 256;
    const long long blocks = (D * D + D + threads - 1) / threads;
    vi_assemble_kernel<<<(unsigned)blocks, threads, 0, s>>>(
        W, (const float*)He, (const float*)ge, (const int*)prev,
        (const uint8_t*)valid, (const float*)state, (const float*)cst,
        (const float*)Hpp, (const float*)bp, (float*)H, (float*)b);
    return (int)cudaGetLastError();
}

extern "C" int vi_edges_cost(const void* state, const void* cst,
                             const void* prev, const void* valid, int W,
                             void* out, void* stream) {
    vi_cost_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
        W, (const float*)state, (const float*)cst, (const int*)prev,
        (const uint8_t*)valid, (float*)out);
    return (int)cudaGetLastError();
}
