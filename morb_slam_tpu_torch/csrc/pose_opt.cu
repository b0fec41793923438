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
// ~12 ns at 3.35 TB/s) and does ~400 flops per observation and step (19
// steps: ~9 Mflop, ~0.14 us at 67 TFLOP/s). Every step depends on the pose
// the step before it produced, so the chain of ~20 steps, each a reduction
// over all observations followed by a 6x6 solve, sets the time. The
// reference program issues that chain as a few hundred small kernels per
// call; here it stays inside one block.
//
// Design: one block of 512 threads per call, grid-stride over the N
// observations (each thread always owns the same rows, so the per-row
// active flags live in the `inliers` output and need no synchronisation).
// Per step each thread builds its rows' residuals, 2x6 (and for stereo rows
// 1x6) Jacobians and Huber weights, and accumulates the 21 upper-triangle
// entries of H and the 6 of g; a warp-shuffle butterfly and a shared-memory
// pass over the 16 warps (in a fixed order) reduce them; one thread adds
// 1e-6 I, inverts H by the plain version's blockwise closed form, applies
// se3_exp with its small-angle branches and left-composes the pose, which
// the block reads after a barrier. Between rounds the rows are reclassified
// by chi2 against 5.991 (mono) / 7.815 (stereo, finite obs_ur). Rows that
// are inactive or behind the camera (z <= 0) add exactly zero. The pose and
// chi2 arithmetic follows the plain version's formulas and constants; the
// sums over rows run in another order than its einsums, so results agree to
// float32 rounding, not bitwise.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 512
#define NWARPS (THREADS / 32)
#define NACC 27  // 21 upper-triangle H entries + 6 g entries

#define CHI2_MONO 5.991f
#define CHI2_STEREO 7.815f

struct Pose {
    float R[9];
    float t[3];
};

// Residuals and chi2 of row i at pose P (the plain gn_step's formulas).
struct RowEval {
    float x, y, z, zs, rx, ry, rur, chi2, th;
    bool stereo;
};

__device__ __forceinline__ RowEval eval_row(const Pose& P, const float* Xw,
                                            const float* obs, int obs_stride,
                                            const float* info,
                                            const float* obs_ur,
                                            float baseline, int i) {
    RowEval e;
    const float X0 = Xw[3 * (size_t)i], X1 = Xw[3 * (size_t)i + 1],
                X2 = Xw[3 * (size_t)i + 2];
    float Xc[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        float s = __fmul_rn(P.R[3 * r], X0);
        s = __fadd_rn(s, __fmul_rn(P.R[3 * r + 1], X1));
        s = __fadd_rn(s, __fmul_rn(P.R[3 * r + 2], X2));
        Xc[r] = __fadd_rn(s, P.t[r]);
    }
    e.x = Xc[0];
    e.y = Xc[1];
    e.z = Xc[2];
    e.zs = fabsf(e.z) < 1e-9f ? 1e-9f : e.z;
    const float ox = obs[(size_t)i * obs_stride];
    const float oy = obs[(size_t)i * obs_stride + 1];
    e.rx = __fsub_rn(__fdiv_rn(e.x, e.zs), ox);
    e.ry = __fsub_rn(__fdiv_rn(e.y, e.zs), oy);
    const float ur = obs_ur ? obs_ur[i] : __int_as_float(0x7fc00000);
    e.stereo = isfinite(ur);
    e.rur = e.stereo
        ? __fsub_rn(__fdiv_rn(__fsub_rn(e.x, baseline), e.zs), ur) : 0.0f;
    const float s2 = __fadd_rn(__fadd_rn(__fmul_rn(e.rx, e.rx),
                                         __fmul_rn(e.ry, e.ry)),
                               __fmul_rn(e.rur, e.rur));
    e.chi2 = __fmul_rn(s2, info[i]);
    e.th = e.stereo ? CHI2_STEREO : CHI2_MONO;
    return e;
}

// Accumulate one residual row with Jacobian rows (a, b, c) wrt the point in
// camera coordinates, chained through d Xc / d dx = [I | -hat(Xc)].
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
        for (int q = p; q < 6; ++q) acc[k++] += wp * J[q];
    }
#pragma unroll
    for (int p = 0; p < 6; ++p) acc[21 + p] += w * J[p] * r;
}

__device__ void inv3x3(const float* M, float* out) {
    const float a = M[0], b = M[1], c = M[2];
    const float d = M[3], e = M[4], f = M[5];
    const float g = M[6], h = M[7], i = M[8];
    const float A = e * i - f * h, B = c * h - b * i, C = b * f - c * e;
    const float D = f * g - d * i, E = a * i - c * g, F = c * d - a * f;
    const float G = d * h - e * g, H = b * g - a * h, I = a * e - b * d;
    float det = a * A + b * D + c * G;
    if (fabsf(det) < 1e-12f) det = 1e-12f;
    out[0] = A / det; out[1] = B / det; out[2] = C / det;
    out[3] = D / det; out[4] = E / det; out[5] = F / det;
    out[6] = G / det; out[7] = H / det; out[8] = I / det;
}

__device__ void mm3(const float* A, const float* B, float* C) {
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                           A[3 * i + 2] * B[6 + j];
}

// dx = -(inv6x6(H) g) with the blockwise 3x3 Schur-complement inverse of
// optim/linalg.py:inv6x6.
__device__ void solve6(const float* H, const float* g, float* dx) {
    float A[9], B[9], C[9], D[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            A[3 * i + j] = H[6 * i + j];
            B[3 * i + j] = H[6 * i + 3 + j];
            C[3 * i + j] = H[6 * (3 + i) + j];
            D[3 * i + j] = H[6 * (3 + i) + 3 + j];
        }
    float Ai[9], AiB[9], CAi[9], CAiB[9], S[9], Si[9], T[9], U[9];
    inv3x3(A, Ai);
    mm3(Ai, B, AiB);
    mm3(C, AiB, CAiB);
    for (int k = 0; k < 9; ++k) S[k] = D[k] - CAiB[k];
    inv3x3(S, Si);
    mm3(C, Ai, CAi);
    float Hi[36];
    mm3(Si, CAi, T);    // Si CAi
    mm3(AiB, T, U);     // AiB (Si CAi)
    float V[9];
    mm3(AiB, Si, V);
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            Hi[6 * i + j] = Ai[3 * i + j] + U[3 * i + j];
            Hi[6 * i + 3 + j] = -V[3 * i + j];
            Hi[6 * (3 + i) + j] = -T[3 * i + j];
            Hi[6 * (3 + i) + 3 + j] = Si[3 * i + j];
        }
    for (int a = 0; a < 6; ++a) {
        float s = 0.0f;
        for (int b = 0; b < 6; ++b) s += Hi[6 * a + b] * g[b];
        dx[a] = -s;
    }
}

// lie.py: _sinc, _cosc, _sinc3 with their |x| < 1e-4 series branches.
__device__ float sinc_(float x) {
    return fabsf(x) < 1e-4f ? 1.0f - x * x / 6.0f : sinf(x) / x;
}
__device__ float cosc_(float x) {
    return fabsf(x) < 1e-4f ? 0.5f - x * x / 24.0f
                            : (1.0f - cosf(x)) / (x * x);
}
__device__ float sinc3_(float x) {
    return fabsf(x) < 1e-4f ? 1.0f / 6.0f - x * x / 120.0f
                            : (x - sinf(x)) / (x * x * x);
}

// P <- exp(dx) P (lie.se3_exp, then lie.se3_mul(dR, dt, R, t)).
__device__ void apply_update(Pose& P, const float* dx) {
    const float* rho = dx;
    const float* w = dx + 3;
    const float n2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
    const float theta = sqrtf(n2 + 1e-24f);
    const float Wh[9] = {0.0f, -w[2], w[1], w[2], 0.0f, -w[0],
                         -w[1], w[0], 0.0f};
    float W2[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            W2[3 * i + j] = w[i] * w[j] - (i == j ? n2 : 0.0f);
    const float a = sinc_(theta), b = cosc_(theta), c = sinc3_(theta);
    float dR[9], Jl[9];
    for (int k = 0; k < 9; ++k) {
        const float I = (k % 4 == 0) ? 1.0f : 0.0f;
        dR[k] = I + a * Wh[k] + b * W2[k];
        Jl[k] = I + b * Wh[k] + c * W2[k];
    }
    float dt[3];
    for (int i = 0; i < 3; ++i)
        dt[i] = Jl[3 * i] * rho[0] + Jl[3 * i + 1] * rho[1] +
                Jl[3 * i + 2] * rho[2];
    float R[9], t[3];
    mm3(dR, P.R, R);
    for (int i = 0; i < 3; ++i)
        t[i] = dR[3 * i] * P.t[0] + dR[3 * i + 1] * P.t[1] +
               dR[3 * i + 2] * P.t[2] + dt[i];
    for (int k = 0; k < 9; ++k) P.R[k] = R[k];
    for (int k = 0; k < 3; ++k) P.t[k] = t[k];
}

__global__ void __launch_bounds__(THREADS)
pose_opt_kernel(const float* __restrict__ R0, const float* __restrict__ t0,
                const float* __restrict__ Xw, const float* __restrict__ obs,
                int obs_stride, const float* __restrict__ info,
                const uint8_t* __restrict__ valid,
                const float* __restrict__ obs_ur, float baseline, int N,
                int n_rounds, int n_iters, float* __restrict__ R_out,
                float* __restrict__ t_out, uint8_t* __restrict__ inliers,
                float* __restrict__ chi2_out,
                long long* __restrict__ n_inliers) {
    __shared__ Pose sP;
    __shared__ float red[NWARPS][NACC];
    __shared__ int cnt[NWARPS];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid < 9) sP.R[tid] = R0[tid];
    if (tid < 3) sP.t[tid] = t0[tid];
    // the active flags of the rows live in `inliers` until the end
    for (int i = tid; i < N; i += THREADS) inliers[i] = valid[i] ? 1 : 0;
    __syncthreads();

    for (int round = 0; round <= n_rounds; ++round) {
        const int steps = round < n_rounds ? n_iters : 0;
        for (int it = 0; it < steps; ++it) {
            const Pose P = sP;
            float acc[NACC];
#pragma unroll
            for (int k = 0; k < NACC; ++k) acc[k] = 0.0f;
            for (int i = tid; i < N; i += THREADS) {
                if (!inliers[i]) continue;
                const RowEval e = eval_row(P, Xw, obs, obs_stride, info,
                                           obs_ur, baseline, i);
                if (!(e.z > 0.0f)) continue;
                const float hub = e.chi2 <= e.th
                    ? 1.0f : sqrtf(e.th / fmaxf(e.chi2, 1e-12f));
                const float w = info[i] * hub;
                if (w == 0.0f) continue;
                const float iz = 1.0f / e.zs, iz2 = iz * iz;
                add_row(acc, w, e.rx, iz, 0.0f, -e.x * iz2, e.x, e.y, e.z);
                add_row(acc, w, e.ry, 0.0f, iz, -e.y * iz2, e.x, e.y, e.z);
                if (e.stereo)
                    add_row(acc, w, e.rur, iz, 0.0f,
                            -(e.x - baseline) * iz2, e.x, e.y, e.z);
            }
#pragma unroll
            for (int k = 0; k < NACC; ++k) {
                float v = acc[k];
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
                    v += __shfl_xor_sync(0xffffffffu, v, off);
                if (lane == 0) red[warp][k] = v;
            }
            __syncthreads();
            if (tid == 0) {
                float Hs[36], g[6], dx[6];
                float tot[NACC];
                for (int k = 0; k < NACC; ++k) {
                    float s = 0.0f;
                    for (int wq = 0; wq < NWARPS; ++wq) s += red[wq][k];
                    tot[k] = s;
                }
                int k = 0;
                for (int p = 0; p < 6; ++p)
                    for (int q = p; q < 6; ++q) {
                        Hs[6 * p + q] = tot[k];
                        Hs[6 * q + p] = tot[k];
                        ++k;
                    }
                for (int p = 0; p < 6; ++p) {
                    Hs[7 * p] += 1e-6f;
                    g[p] = tot[21 + p];
                }
                solve6(Hs, g, dx);
                Pose P2 = sP;
                apply_update(P2, dx);
                sP = P2;
            }
            __syncthreads();
        }
        // reclassify (after the last round: the final classification)
        const Pose P = sP;
        int n = 0;
        for (int i = tid; i < N; i += THREADS) {
            const RowEval e = eval_row(P, Xw, obs, obs_stride, info, obs_ur,
                                       baseline, i);
            const uint8_t in = (valid[i] && e.chi2 < e.th) ? 1 : 0;
            inliers[i] = in;
            n += in;
            if (round == n_rounds) chi2_out[i] = e.chi2;
        }
        if (round == n_rounds) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                n += __shfl_xor_sync(0xffffffffu, n, off);
            if (lane == 0) cnt[warp] = n;
        }
        __syncthreads();
    }
    if (tid == 0) {
        long long n = 0;
        for (int wq = 0; wq < NWARPS; ++wq) n += cnt[wq];
        *n_inliers = n;
    }
    if (tid < 9) R_out[tid] = sP.R[tid];
    if (tid < 3) t_out[tid] = sP.t[tid];
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
