// K5: motion-only pose optimization, the whole robust Gauss-Newton solve of
// one SE(3) pose in one launch.
//
// Replaces morb_slam_tpu/optim/pose_opt.py:optimize_pose (its gn_step and
// the optimize-then-reclassify rounds), which tracking runs twice per frame
// (2 rounds x 8 iterations) and relocalization and the reference-keyframe
// fallback run at 3 rounds x 10 iterations.
//
// What bounds it on an H100: neither bytes nor operations, but latency. The
// function reads ~33 B per observation once (1200 observations: ~40 KB,
// ~12 ns at 3.35 TB/s) and does ~200-280 flops per active observation and
// step (19 steps: ~5 Mflop, ~0.07 us at 67 TFLOP/s). Every step depends on
// the pose the step before it produced, so the chain of ~20 steps, each a
// pass over the rows, a reduction over the block and a 6x6 solve, sets the
// time.
//
// Design: one block of THREADS threads, no cluster and no second block. At
// 1,200 rows, clock64() stamps on an H100 put ~55% of a step in the row
// pass (issue-bound on the one SM), ~18% in the warps' sums and ~1/4 in
// warp 0's serial solve and update.
//  - Rows stay close: thread t owns rows t + r * THREADS. The first CAP =
//    1536 rows (above the tracker's 1,200 features) are loaded once a call
//    into registers (point, observation, information, right coordinate,
//    active flag); rows above the cap are read from global memory in every
//    step, their active flags kept in the `inliers` output, as before.
//  - The row pass takes one reciprocal of z per row and multiplies (the
//    plain version divides three times), and is branch-free over a
//    thread's register rows so that they interleave: inactive rows and
//    rows behind the camera get weight 0 and a unit depth, so no lane
//    takes a reciprocal or root of a garbage value. The reciprocal and the
//    Huber weight sqrt(th) rsqrt(chi2) are MUFU approximations (a few ulp;
//    the IEEE forms branch to a slow path, which keeps the rows apart).
//  - Each warp reduces its 27 sums (21 upper entries of H, 6 of g) by a
//    transposed butterfly: 31 shuffles leave entry k on lane k.
//  - Barrier 1. Warp 0 sums the warps' partials, lane k entry k in warp
//    order, publishes the 27 totals through shared memory to its lanes, and
//    every lane of warp 0 solves (H + 1e-6 I) dx = -g by the plain
//    version's blockwise 3x3 Schur form (optim/linalg.py:inv6x6, with the
//    same determinant floors), applied to g directly and with one
//    reciprocal per 3x3 determinant, then se3_exp with the small-angle
//    branches of lie.py and the left composition, all in registers (the
//    lanes agree; lane 0 stores the pose). Barrier 2 publishes it.
//  - Reclassification (chi2 against 5.991 mono / 7.815 stereo, finite
//    obs_ur) touches only each thread's own rows and needs no barrier; it
//    keeps the plain version's IEEE divisions and its order of the point
//    transform, so chi2 and the inlier flags follow the plain formulas.
// Two barriers per step. The sums run in another order than the plain
// einsums, so results agree to float32 rounding, not bitwise.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256                // at 512 the row pass and sums took longer
#define NWARPS (THREADS / 32)
#define CAP 1536                   // rows held in registers
#define ROWS (CAP / THREADS)       // register rows per thread
#define NACC 27                    // 21 upper-triangle H entries + 6 g
#define FULL 0xffffffffu

#define CHI2_MONO 5.991f
#define CHI2_STEREO 7.815f
#define SQRT_CHI2_MONO 2.4476519f      // sqrt(5.991)
#define SQRT_CHI2_STEREO 2.7955322f    // sqrt(7.815)

// One observation: the point in the world, its normalized observation,
// information and right-image coordinate (NaN: mono).
struct Row {
    float X0, X1, X2, ox, oy, info, ur;
};

__device__ __forceinline__ Row load_row(const float* __restrict__ Xw,
                                        const float* __restrict__ obs,
                                        int obs_stride,
                                        const float* __restrict__ info,
                                        const float* __restrict__ obs_ur,
                                        int i) {
    Row r;
    r.X0 = Xw[3 * (size_t)i];
    r.X1 = Xw[3 * (size_t)i + 1];
    r.X2 = Xw[3 * (size_t)i + 2];
    r.ox = obs[(size_t)i * obs_stride];
    r.oy = obs[(size_t)i * obs_stride + 1];
    r.info = info[i];
    r.ur = obs_ur ? obs_ur[i] : __int_as_float(0x7fc00000);
    return r;
}

// Accumulate one residual row with Jacobian rows (a, b, c) wrt the point in
// camera coordinates, chained through d Xc / d dx = [I | -hat(Xc)]. Entry
// ZERO of J is zero (b for the x and right-image rows, a for the y row):
// its products, exact zeros, are left out.
template <int ZERO>
__device__ __forceinline__ void add_row(float* acc, float w, float r,
                                        float a, float b, float c, float x,
                                        float y, float z) {
    float J[6];
    J[0] = a;
    J[1] = b;
    J[2] = c;
    J[3] = -b * z + c * y;
    J[4] = a * z - c * x;
    J[5] = -a * y + b * x;
    int k = 0;
#pragma unroll
    for (int p = 0; p < 6; ++p) {
        const float wp = w * J[p];
#pragma unroll
        for (int q = p; q < 6; ++q, ++k)
            if (p != ZERO && q != ZERO) acc[k] += wp * J[q];
    }
#pragma unroll
    for (int p = 0; p < 6; ++p)
        if (p != ZERO) acc[21 + p] += w * J[p] * r;
}

// The Gauss-Newton terms of K rows at pose P (R row-major, t); bit r of
// `act` marks row r active. Branch-free over the rows, so the compiler can
// interleave them: a row that is inactive or behind the camera gets weight
// 0 and a unit depth (its terms are exact zeros, and no reciprocal or root
// sees a garbage value); 1 / z by MUFU.RCP and the Huber weight sqrt(th /
// chi2) as sqrt(th) rsqrt(chi2), both branch-free. The right-image rows
// follow for the warp's lanes (`lanes`) if any lane has one.
template <int K>
__device__ __forceinline__ void gn_rows(float* acc, const float* P,
                                        const Row* rows, unsigned act,
                                        float baseline, unsigned lanes) {
    float X[K], Y[K], Z[K], IZ[K], RU[K], WS[K];
    bool any_stereo = false;
#pragma unroll
    for (int r = 0; r < K; ++r) {
        const Row& o = rows[r];
        const float x = fmaf(P[0], o.X0, fmaf(P[1], o.X1, fmaf(P[2], o.X2, P[9])));
        const float y = fmaf(P[3], o.X0, fmaf(P[4], o.X1, fmaf(P[5], o.X2, P[10])));
        const float z = fmaf(P[6], o.X0, fmaf(P[7], o.X1, fmaf(P[8], o.X2, P[11])));
        const bool use = ((act >> r) & 1u) && z > 0.0f;
        const float iz = __fdividef(1.0f, use ? fmaxf(z, 1e-9f) : 1.0f);
        const float rx = fmaf(x, iz, -o.ox), ry = fmaf(y, iz, -o.oy);
        const bool stereo = use && isfinite(o.ur);
        const float rur = stereo ? fmaf(x - baseline, iz, -o.ur) : 0.0f;
        const float chi2 = (rx * rx + ry * ry + rur * rur) * o.info;
        const float hub = chi2 <= (stereo ? CHI2_STEREO : CHI2_MONO)
            ? 1.0f : (stereo ? SQRT_CHI2_STEREO : SQRT_CHI2_MONO) * rsqrtf(chi2);
        const float w = use ? o.info * hub : 0.0f;
        const float iz2 = iz * iz;
        add_row<1>(acc, w, rx, iz, 0.0f, -x * iz2, x, y, z);
        add_row<0>(acc, w, ry, 0.0f, iz, -y * iz2, x, y, z);
        X[r] = x;
        Y[r] = y;
        Z[r] = z;
        IZ[r] = iz;
        RU[r] = rur;
        WS[r] = stereo ? w : 0.0f;
        any_stereo |= stereo;
    }
    if (__any_sync(lanes, any_stereo)) {
#pragma unroll
        for (int r = 0; r < K; ++r)
            add_row<1>(acc, WS[r], RU[r], IZ[r], 0.0f,
                    -(X[r] - baseline) * IZ[r] * IZ[r], X[r], Y[r], Z[r]);
    }
}

// chi2 of a row at pose P and its gate, by the plain gn_step's formulas (the
// point transform in its order, IEEE divisions).
__device__ __forceinline__ float row_chi2(const float* P, const Row& o,
                                          float baseline, float* th) {
    float Xc[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        float s = __fmul_rn(P[3 * r], o.X0);
        s = __fadd_rn(s, __fmul_rn(P[3 * r + 1], o.X1));
        s = __fadd_rn(s, __fmul_rn(P[3 * r + 2], o.X2));
        Xc[r] = __fadd_rn(s, P[9 + r]);
    }
    const float zs = fabsf(Xc[2]) < 1e-9f ? 1e-9f : Xc[2];
    const float rx = __fsub_rn(__fdiv_rn(Xc[0], zs), o.ox);
    const float ry = __fsub_rn(__fdiv_rn(Xc[1], zs), o.oy);
    const bool stereo = isfinite(o.ur);
    const float rur = stereo
        ? __fsub_rn(__fdiv_rn(__fsub_rn(Xc[0], baseline), zs), o.ur) : 0.0f;
    const float s2 = __fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)),
                               __fmul_rn(rur, rur));
    *th = stereo ? CHI2_STEREO : CHI2_MONO;
    return __fmul_rn(s2, o.info);
}

// Transposed butterfly: v[0..31] of every lane in, the warp's sum of entry
// `lane` out. Each level keeps half of the entries and receives the
// partner's partial sums of that half (16 + 8 + 4 + 2 + 1 shuffles).
template <int H>
__device__ __forceinline__ void transpose_level(float* v, int lane) {
    const bool up = lane & H;
#pragma unroll
    for (int k = 0; k < H; ++k) {
        const float send = up ? v[k] : v[k + H];
        const float keep = up ? v[k + H] : v[k];
        v[k] = keep + __shfl_xor_sync(FULL, send, H);
    }
}
__device__ __forceinline__ float warp_transpose_sum(float* v, int lane) {
    transpose_level<16>(v, lane);
    transpose_level<8>(v, lane);
    transpose_level<4>(v, lane);
    transpose_level<2>(v, lane);
    transpose_level<1>(v, lane);
    return v[0];
}

// optim/linalg.py:inv3x3 (adjugate, |det| < 1e-12 floored to 1e-12), the
// division by det as one reciprocal.
__device__ __forceinline__ void inv3x3(const float* M, float* out) {
    const float a = M[0], b = M[1], c = M[2];
    const float d = M[3], e = M[4], f = M[5];
    const float g = M[6], h = M[7], i = M[8];
    const float A = e * i - f * h, B = c * h - b * i, C = b * f - c * e;
    const float D = f * g - d * i, E = a * i - c * g, F = c * d - a * f;
    const float G = d * h - e * g, H = b * g - a * h, I = a * e - b * d;
    float det = a * A + b * D + c * G;
    if (fabsf(det) < 1e-12f) det = 1e-12f;
    const float r = __frcp_rn(det);
    out[0] = A * r; out[1] = B * r; out[2] = C * r;
    out[3] = D * r; out[4] = E * r; out[5] = F * r;
    out[6] = G * r; out[7] = H * r; out[8] = I * r;
}

__device__ __forceinline__ void mv3(const float* M, const float* v,
                                    float* o) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
        o[i] = M[3 * i] * v[0] + M[3 * i + 1] * v[1] + M[3 * i + 2] * v[2];
}

// dx = -(H + 1e-6 I)^-1 g from the 27 sums, by the blocks of inv6x6:
// H = [A B; B^T D], S = D - B^T A^-1 B, x2 = S^-1 (g2 - B^T A^-1 g1),
// x1 = A^-1 (g1 - B x2).
__device__ __forceinline__ void solve6(const float* tot, float* dx) {
    float Hs[36];
    int k = 0;
#pragma unroll
    for (int p = 0; p < 6; ++p)
#pragma unroll
        for (int q = p; q < 6; ++q) {
            Hs[6 * p + q] = tot[k];
            Hs[6 * q + p] = tot[k];
            ++k;
        }
#pragma unroll
    for (int p = 0; p < 6; ++p) Hs[7 * p] += 1e-6f;
    float A[9], B[9], D[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            A[3 * i + j] = Hs[6 * i + j];
            B[3 * i + j] = Hs[6 * i + 3 + j];
            D[3 * i + j] = Hs[6 * (3 + i) + 3 + j];
        }
    float Ai[9], AiB[9], S[9], Si[9];
    inv3x3(A, Ai);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            AiB[3 * i + j] = Ai[3 * i] * B[j] + Ai[3 * i + 1] * B[3 + j] +
                             Ai[3 * i + 2] * B[6 + j];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            S[3 * i + j] = D[3 * i + j] - (B[i] * AiB[j] +
                                           B[3 + i] * AiB[3 + j] +
                                           B[6 + i] * AiB[6 + j]);
    inv3x3(S, Si);
    const float* g = tot + 21;
    float y1[3], r2[3], x2[3], r1[3], x1[3];
    mv3(Ai, g, y1);
#pragma unroll
    for (int i = 0; i < 3; ++i)
        r2[i] = g[3 + i] - (B[i] * y1[0] + B[3 + i] * y1[1] +
                            B[6 + i] * y1[2]);
    mv3(Si, r2, x2);
#pragma unroll
    for (int i = 0; i < 3; ++i)
        r1[i] = g[i] - (B[3 * i] * x2[0] + B[3 * i + 1] * x2[1] +
                        B[3 * i + 2] * x2[2]);
    mv3(Ai, r1, x1);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        dx[i] = -x1[i];
        dx[3 + i] = -x2[i];
    }
}

// lie.py: _sinc, _cosc, _sinc3 with their |x| < 1e-4 series branches.
__device__ __forceinline__ void exp_coeffs(float x, float* a, float* b,
                                           float* c) {
    if (fabsf(x) < 1e-4f) {     // the series by products, not divisions
        const float x2 = x * x;
        *a = 1.0f - x2 * (1.0f / 6.0f);
        *b = 0.5f - x2 * (1.0f / 24.0f);
        *c = 1.0f / 6.0f - x2 * (1.0f / 120.0f);
        return;
    }
    float s, co;
    sincosf(x, &s, &co);
    const float ix = __frcp_rn(x), ix2 = ix * ix;
    *a = s * ix;
    *b = (1.0f - co) * ix2;
    *c = (x - s) * ix2 * ix;
}

// Pn = exp(dx) P (lie.se3_exp, then lie.se3_mul(dR, dt, R, t)); R
// row-major in 0-8, t in 9-11.
__device__ __forceinline__ void apply_update(const float* P, const float* dx,
                                             float* Pn) {
    const float* rho = dx;
    const float* w = dx + 3;
    const float n2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
    const float theta = sqrtf(n2 + 1e-24f);
    const float Wh[9] = {0.0f, -w[2], w[1], w[2], 0.0f, -w[0],
                         -w[1], w[0], 0.0f};
    float a, b, c;
    exp_coeffs(theta, &a, &b, &c);
    float dR[9], Jl[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const float W2 = w[i] * w[j] - (i == j ? n2 : 0.0f);
            const float I = i == j ? 1.0f : 0.0f;
            dR[3 * i + j] = I + a * Wh[3 * i + j] + b * W2;
            Jl[3 * i + j] = I + b * Wh[3 * i + j] + c * W2;
        }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j)
            Pn[3 * i + j] = dR[3 * i] * P[j] + dR[3 * i + 1] * P[3 + j] +
                            dR[3 * i + 2] * P[6 + j];
        const float dt = Jl[3 * i] * rho[0] + Jl[3 * i + 1] * rho[1] +
                         Jl[3 * i + 2] * rho[2];
        Pn[9 + i] = dR[3 * i] * P[9] + dR[3 * i + 1] * P[10] +
                    dR[3 * i + 2] * P[11] + dt;
    }
}

__global__ void __launch_bounds__(THREADS, 1)
pose_opt_kernel(const float* __restrict__ R0, const float* __restrict__ t0,
                const float* __restrict__ Xw, const float* __restrict__ obs,
                int obs_stride, const float* __restrict__ info,
                const uint8_t* __restrict__ valid,
                const float* __restrict__ obs_ur, float baseline, int N,
                int n_rounds, int n_iters, float* __restrict__ R_out,
                float* __restrict__ t_out, uint8_t* __restrict__ inliers,
                float* __restrict__ chi2_out,
                long long* __restrict__ n_inliers) {
    __shared__ float sP[12];
    __shared__ float red[NWARPS][32];
    __shared__ float tot[32];
    __shared__ int cnt[NWARPS];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float P[12];
#pragma unroll
    for (int k = 0; k < 9; ++k) P[k] = R0[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) P[9 + k] = t0[k];
    // the register rows and their active flags (bit r: row tid + r THREADS)
    Row rows[ROWS];
    unsigned act = 0u;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const int i = tid + r * THREADS;
        if (i < N) {
            rows[r] = load_row(Xw, obs, obs_stride, info, obs_ur, i);
            if (valid[i]) act |= 1u << r;
        } else {
            rows[r] = Row{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        }
    }
    // rows above the cap keep their active flags in `inliers`
    for (int i = CAP + tid; i < N; i += THREADS) inliers[i] = valid[i] ? 1 : 0;

    for (int round = 0; round <= n_rounds; ++round) {
        const int steps = round < n_rounds ? n_iters : 0;
        for (int it = 0; it < steps; ++it) {
            float acc[32];
#pragma unroll
            for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
            gn_rows<ROWS>(acc, P, rows, act, baseline, FULL);
            for (int i = CAP + tid; i < N; i += THREADS) {
                const Row o = load_row(Xw, obs, obs_stride, info, obs_ur, i);
                gn_rows<1>(acc, P, &o, inliers[i] ? 1u : 0u, baseline,
                           __activemask());
            }
            red[warp][lane] = warp_transpose_sum(acc, lane);
            __syncthreads();
            if (warp == 0) {
                float s = 0.0f;
#pragma unroll
                for (int q = 0; q < NWARPS; ++q) s += red[q][lane];
                tot[lane] = s;
                __syncwarp();
                float t[NACC];
#pragma unroll
                for (int k = 0; k < NACC; ++k) t[k] = tot[k];
                float dx[6], Pn[12];
                solve6(t, dx);
                apply_update(P, dx, Pn);
                if (lane == 0)
#pragma unroll
                    for (int k = 0; k < 12; ++k) sP[k] = Pn[k];
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < 12; ++k) P[k] = sP[k];
        }
        // reclassify the own rows (after the last round: the final
        // classification, written out)
        const bool final_round = round == n_rounds;
        int n = 0;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            const int i = tid + r * THREADS;
            if (i >= N) continue;
            float th;
            const float chi2 = row_chi2(P, rows[r], baseline, &th);
            const bool in = valid[i] && chi2 < th;
            act = in ? (act | (1u << r)) : (act & ~(1u << r));
            if (final_round) {
                inliers[i] = in ? 1 : 0;
                chi2_out[i] = chi2;
                n += in;
            }
        }
        for (int i = CAP + tid; i < N; i += THREADS) {
            float th;
            const float chi2 = row_chi2(
                P, load_row(Xw, obs, obs_stride, info, obs_ur, i), baseline,
                &th);
            const bool in = valid[i] && chi2 < th;
            inliers[i] = in ? 1 : 0;
            if (final_round) {
                chi2_out[i] = chi2;
                n += in;
            }
        }
        if (final_round) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                n += __shfl_xor_sync(FULL, n, off);
            if (lane == 0) cnt[warp] = n;
        }
    }
    __syncthreads();
    if (tid == 0) {
        long long n = 0;
        for (int q = 0; q < NWARPS; ++q) n += cnt[q];
        *n_inliers = n;
#pragma unroll
        for (int k = 0; k < 9; ++k) R_out[k] = P[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) t_out[k] = P[9 + k];
    }
}

extern "C" int pose_opt(const void* R0, const void* t0, const void* Xw,
                        const void* obs, int obs_stride, const void* info,
                        const void* valid, const void* obs_ur, float baseline,
                        int N, int n_rounds, int n_iters, void* R, void* t,
                        void* inliers, void* chi2, void* n_inliers,
                        void* stream) {
    pose_opt_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)R0, (const float*)t0, (const float*)Xw,
        (const float*)obs, obs_stride, (const float*)info,
        (const uint8_t*)valid, (const float*)obs_ur, baseline, N, n_rounds,
        n_iters, (float*)R, (float*)t, (uint8_t*)inliers, (float*)chi2,
        (long long*)n_inliers);
    return (int)cudaGetLastError();
}
