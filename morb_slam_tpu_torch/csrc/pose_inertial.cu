// K12: the per-frame visual-inertial pose optimization, every Gauss-Newton
// step and reclassification round of one call in one launch.
//
// Replaces morb_slam_tpu/optim/vi_ba.py:optimize_pose_inertial (its
// gn_step and round_body), which the visual-inertial tracker runs on every
// frame after the IMU initialization: 2 rounds x (6 steps + 1
// reclassification) + 1 final evaluation over the 30-dim (anchor keyframe,
// current frame) state.
//
// What bounds it on an H100: latency. The call reads ~33 B per observation
// (1,200 observations: ~40 KB) and ~0.8 KB of edge constants; each step
// does ~400 flops per observation plus ~60 Kflop for the edge Jacobian, the
// 30x30 products and the Cholesky (15 steps: ~8 Mflop). Every step needs
// the state the step before it produced, so the chain of 15 steps, each a
// reduction over the observations followed by a dense 30x30 solve, sets the
// time. The reference program issues it as one XLA loop; plain PyTorch
// issues several hundred kernels per step.
//
// Design (K5's, csrc/pose_opt.cu, extended): one block of 512 threads; the
// 30-dim state lives in shared memory.
//  - Visual terms: each thread owns a fixed stride of observations (their
//    active flags live in the `inliers` output), builds residuals, the body-
//    tangent Jacobian rows J_pt [-I | hat(Xc)] and Huber weights, and
//    accumulates the 21 upper entries of H_v and the 6 of J^T w r; a fixed-
//    order warp butterfly and a pass over the 16 warps reduce them.
//  - The inertial edge Jacobian in forward mode (imu_edge.cuh, shared with
//    K13): lane d of warp 0 (d < 30) evaluates vi_ba._edge_residual on
//    (value, derivative) pairs seeded with the unit tangent e_d, through
//    so3_exp, so3_log and the 3x3 products with the port's lie.py branches
//    (the clamp of cos(theta) passes no derivative, as torch's clamp),
//    giving column d of Je (9 x 30).
//  - Assembly: Je^T Omega Je and -Je^T Omega r one entry per thread; the
//    visual block on dims 15:21, the bias random walk, the mask that fixes
//    the anchor, symmetrization, Jacobi scaling + 1e-6 I; warp 0
//    factors the 30x30 SPD system by a right-looking Cholesky (lane i owns
//    row i), lane 0 substitutes and applies the update.
// The arithmetic follows the plain version's formulas; the sums run in
// another order than its einsums, so results agree to float32 rounding.
#include <cuda_runtime.h>
#include <stdint.h>

#include "imu_edge.cuh"

#define THREADS 512
#define NWARPS (THREADS / 32)
#define NACC 27
#define HUBER2_MONO 5.991f
#define HUBER2_STEREO 7.815f

// offsets into the packed constants (optim/vi_ba.py optimize_pose_inertial)
#define C_R0 0
#define C_T0 9
#define C_V0 12
#define C_B0 15
#define C_RA 21
#define C_PA 30
#define C_VA 33
#define C_BA 36
#define C_DT 42
#define C_DR 43
#define C_DV 52
#define C_DP 55
#define C_JRG 58
#define C_JVG 67
#define C_JVA 76
#define C_JPG 85
#define C_JPA 94
#define C_INFO 103
#define C_BIAS0 184
#define C_RW 190
#define C_BASE 196
#define N_CONST 197

// ---------------------------------------------------------------------------
// plain float helpers for the state update
// ---------------------------------------------------------------------------
__device__ float sinc_(float x) {
    return fabsf(x) < 1e-4f ? 1.0f - x * x / 6.0f : sinf(x) / x;
}
__device__ float cosc_(float x) {
    return fabsf(x) < 1e-4f ? 0.5f - x * x / 24.0f
                            : (1.0f - cosf(x)) / (x * x);
}
__device__ void exp3(const float* w, float* R) {
    const float n2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
    const float th = sqrtf(n2 + 1e-24f);
    const float W[9] = {0.0f, -w[2], w[1], w[2], 0.0f, -w[0],
                        -w[1], w[0], 0.0f};
    const float a = sinc_(th), b = cosc_(th);
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            R[3 * i + j] = (i == j ? 1.0f : 0.0f) + a * W[3 * i + j] +
                           b * (w[i] * w[j] - (i == j ? n2 : 0.0f));
}
// R <- R exp(phi), p <- p + R dp (old R), v += dv, b += db
__device__ void update_state(float* st, const float* dx) {
    float E[9], Rn[9];
    exp3(dx + 3, E);
    for (int i = 0; i < 3; ++i) {
        float s = st[3 * i] * dx[0] + st[3 * i + 1] * dx[1] +
                  st[3 * i + 2] * dx[2];
        st[9 + i] += s;
    }
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            Rn[3 * i + j] = st[3 * i] * E[j] + st[3 * i + 1] * E[3 + j] +
                            st[3 * i + 2] * E[6 + j];
    for (int k = 0; k < 9; ++k) st[k] = Rn[k];
    for (int q = 0; q < 3; ++q) st[12 + q] += dx[6 + q];
    for (int q = 0; q < 6; ++q) st[15 + q] += dx[9 + q];
}

// Residuals and chi2 of observation i at the current body state
struct Row {
    float x, y, z, iz, rx, ry, rur, chi2, th;
    bool stereo;
};
__device__ __forceinline__ Row eval_row(const float* Rcw, const float* tcw,
                                        const float* Xw, const float* obs,
                                        const float* info,
                                        const float* obs_ur, float base,
                                        int i) {
    Row e;
    const float X0 = Xw[3 * (size_t)i], X1 = Xw[3 * (size_t)i + 1],
                X2 = Xw[3 * (size_t)i + 2];
    float Xc[3];
    for (int r = 0; r < 3; ++r)
        Xc[r] = Rcw[3 * r] * X0 + Rcw[3 * r + 1] * X1 + Rcw[3 * r + 2] * X2 +
                tcw[r];
    e.x = Xc[0];
    e.y = Xc[1];
    e.z = Xc[2];
    const float zs = fabsf(e.z) < 1e-9f ? 1e-9f : e.z;
    e.iz = 1.0f / zs;
    e.rx = e.x * e.iz - obs[2 * (size_t)i];
    e.ry = e.y * e.iz - obs[2 * (size_t)i + 1];
    const float ur = obs_ur[i];
    e.stereo = isfinite(ur);
    e.rur = e.stereo ? (e.x - base) * e.iz - ur : 0.0f;
    e.chi2 = (e.rx * e.rx + e.ry * e.ry + e.rur * e.rur) * info[i];
    e.th = e.stereo ? HUBER2_STEREO : HUBER2_MONO;
    return e;
}

// one residual row with J_pt row (a, b, c), chained through the body
// tangent [-I | hat(Xc)]
__device__ __forceinline__ void add_row(float* acc, float w, float r,
                                        float a, float b, float c, float x,
                                        float y, float z) {
    float J[6];
    J[0] = -a;
    J[1] = -b;
    J[2] = -c;
    J[3] = b * z - c * y;
    J[4] = -a * z + c * x;
    J[5] = a * y - b * x;
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

__global__ void __launch_bounds__(THREADS)
pose_inertial_kernel(const float* __restrict__ cst_g,
                     const float* __restrict__ Xw,
                     const float* __restrict__ obs,
                     const float* __restrict__ info,
                     const uint8_t* __restrict__ valid,
                     const float* __restrict__ obs_ur, int N, int n_iters,
                     float* __restrict__ out,
                     uint8_t* __restrict__ inliers,
                     long long* __restrict__ n_inliers) {
    __shared__ float C[N_CONST];
    // state: anchor [R 0, p 9, v 12, b 15], current [R 21, p 30, v 33, b 36]
    __shared__ float S[42];
    __shared__ float Rcw[9], tcw[3];
    __shared__ float red[NWARPS][NACC];
    __shared__ float Je[9][30], re[9], JtW[9][30];
    __shared__ float H[30][30], g[30], dsc[30], Lm[30][30], dx[30];
    __shared__ int cnt[NWARPS];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    for (int k = tid; k < N_CONST; k += THREADS) C[k] = cst_g[k];
    __syncthreads();
    const float base = C[C_BASE];
    if (tid == 0) {
        // anchor body state as given; current from the camera pose
        for (int k = 0; k < 9; ++k) S[k] = C[C_RA + k];
        for (int q = 0; q < 3; ++q) {
            S[9 + q] = C[C_PA + q];
            S[12 + q] = C[C_VA + q];
            S[33 + q] = C[C_V0 + q];
        }
        for (int q = 0; q < 6; ++q) {
            S[15 + q] = C[C_BA + q];
            S[36 + q] = C[C_B0 + q];
        }
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j) S[21 + 3 * i + j] = C[C_R0 + 3 * j + i];
        for (int i = 0; i < 3; ++i)
            S[30 + i] = -(S[21 + 3 * i] * C[C_T0] +
                          S[21 + 3 * i + 1] * C[C_T0 + 1] +
                          S[21 + 3 * i + 2] * C[C_T0 + 2]);
    }
    for (int i = tid; i < N; i += THREADS) inliers[i] = valid[i] ? 1 : 0;
    __syncthreads();

    // 2 rounds x (n_iters steps + reclassification), then the final step
    const int total = 2 * (n_iters + 1) + 1;
    for (int step = 0; step < total; ++step) {
        const int in_round = step % (n_iters + 1);
        const bool final_step = step == total - 1;
        const bool reclass = !final_step && in_round == n_iters;
        if (tid == 0) {       // camera pose of the current body state
            for (int i = 0; i < 3; ++i)
                for (int j = 0; j < 3; ++j) Rcw[3 * i + j] = S[21 + 3 * j + i];
            for (int i = 0; i < 3; ++i)
                tcw[i] = -(Rcw[3 * i] * S[30] + Rcw[3 * i + 1] * S[31] +
                           Rcw[3 * i + 2] * S[32]);
        }
        __syncthreads();
        if (reclass) {
            for (int i = tid; i < N; i += THREADS) {
                const Row e = eval_row(Rcw, tcw, Xw, obs, info, obs_ur,
                                       base, i);
                inliers[i] = (valid[i] && e.chi2 < e.th) ? 1 : 0;
            }
            __syncthreads();
            continue;
        }
        // ---- visual terms on dims 15:21
        float acc[NACC];
#pragma unroll
        for (int k = 0; k < NACC; ++k) acc[k] = 0.0f;
        for (int i = tid; i < N; i += THREADS) {
            if (!inliers[i]) continue;
            const Row e = eval_row(Rcw, tcw, Xw, obs, info, obs_ur, base, i);
            if (!(e.z > 0.0f)) continue;
            const float hub = e.chi2 <= e.th
                ? 1.0f : sqrtf(e.th / fmaxf(e.chi2, 1e-12f));
            const float w = info[i] * hub;
            const float iz2 = e.iz * e.iz;
            add_row(acc, w, e.rx, e.iz, 0.0f, -e.x * iz2, e.x, e.y, e.z);
            add_row(acc, w, e.ry, 0.0f, e.iz, -e.y * iz2, e.x, e.y, e.z);
            if (e.stereo)
                add_row(acc, w, e.rur, e.iz, 0.0f, -(e.x - base) * iz2, e.x,
                        e.y, e.z);
        }
#pragma unroll
        for (int k = 0; k < NACC; ++k) {
            float v = acc[k];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                v += __shfl_xor_sync(0xffffffffu, v, off);
            if (lane == 0) red[warp][k] = v;
        }
        // ---- the inertial edge Jacobian, one tangent per lane of warp 0
        if (warp == 0 && lane < 30) {
            const ImuEdge E{C[C_DT], C + C_DR, C + C_DV, C + C_DP,
                            C + C_JRG, C + C_JVG, C + C_JVA, C + C_JPG,
                            C + C_JPA, C + C_BIAS0};
            Dl r[9];
            edge_residual(lane, S, S + 21, E, r);
            for (int a = 0; a < 9; ++a) Je[a][lane] = r[a].d;
            if (lane == 0)
                for (int a = 0; a < 9; ++a) re[a] = r[a].v;
        }
        __syncthreads();
        // JtW[b][i] = sum_a Je[a][i] info[a][b]
        for (int q = tid; q < 270; q += THREADS) {
            const int b = q / 30, i = q % 30;
            float s = 0.0f;
            for (int a = 0; a < 9; ++a) s += Je[a][i] * C[C_INFO + 9 * a + b];
            JtW[b][i] = s;
        }
        __syncthreads();
        for (int q = tid; q < 900; q += THREADS) {
            const int i = q / 30, j = q % 30;
            float s = 0.0f;
            for (int b = 0; b < 9; ++b) s += JtW[b][i] * Je[b][j];
            H[i][j] = s;
        }
        if (tid < 30) {
            float s = 0.0f;
            for (int b = 0; b < 9; ++b) s += JtW[b][tid] * re[b];
            g[tid] = -s;
        }
        __syncthreads();
        if (tid == 0) {
            float tot[NACC];
            for (int k = 0; k < NACC; ++k) {
                float s = 0.0f;
                for (int wq = 0; wq < NWARPS; ++wq) s += red[wq][k];
                tot[k] = s;
            }
            int k = 0;
            for (int p = 0; p < 6; ++p)
                for (int q = p; q < 6; ++q) {
                    H[15 + p][15 + q] += tot[k];
                    if (q != p) H[15 + q][15 + p] += tot[k];
                    ++k;
                }
            for (int p = 0; p < 6; ++p) g[15 + p] += -tot[21 + p];
            for (int q = 0; q < 6; ++q) {
                const float rw = C[C_RW + q];
                const float rr = S[36 + q] - S[15 + q];
                H[9 + q][9 + q] += rw;
                H[24 + q][24 + q] += rw;
                H[9 + q][24 + q] -= rw;
                H[24 + q][9 + q] -= rw;
                g[9 + q] += rw * rr;
                g[24 + q] += -rw * rr;
            }
        }
        __syncthreads();
        // the anchor keyframe is fixed: its rows and columns become I, 0
        for (int q = tid; q < 900; q += THREADS) {
            const int i = q / 30, j = q % 30;
            if (i < 15 || j < 15) H[i][j] = (i == j) ? 1.0f : 0.0f;
        }
        if (tid < 15) g[tid] = 0.0f;
        __syncthreads();
        // symmetrize (into Lm), then the result back into H
        for (int q = tid; q < 900; q += THREADS) {
            const int i = q / 30, j = q % 30;
            Lm[i][j] = 0.5f * (H[i][j] + H[j][i]);
        }
        __syncthreads();
        for (int q = tid; q < 900; q += THREADS) H[q / 30][q % 30] = Lm[q / 30][q % 30];
        __syncthreads();
        if (final_step) break;
        if (tid < 30) dsc[tid] = sqrtf(fmaxf(H[tid][tid], 1e-8f));
        __syncthreads();
        for (int q = tid; q < 900; q += THREADS) {
            const int i = q / 30, j = q % 30;
            Lm[i][j] = H[i][j] / dsc[i] / dsc[j] + (i == j ? 1e-6f : 0.0f);
        }
        __syncthreads();
        // Cholesky of Lm in place (lower triangle), lane i owns row i
        if (warp == 0) {
            for (int j = 0; j < 30; ++j) {
                if (lane == 0) {
                    float s = Lm[j][j];
                    for (int k = 0; k < j; ++k) s -= Lm[j][k] * Lm[j][k];
                    Lm[j][j] = sqrtf(s);
                }
                __syncwarp();
                if (lane > j && lane < 30) {
                    float s = Lm[lane][j];
                    for (int k = 0; k < j; ++k) s -= Lm[lane][k] * Lm[j][k];
                    Lm[lane][j] = s / Lm[j][j];
                }
                __syncwarp();
            }
            if (lane == 0) {
                float y[30];
                for (int i = 0; i < 30; ++i) {
                    float s = g[i] / dsc[i];
                    for (int k = 0; k < i; ++k) s -= Lm[i][k] * y[k];
                    y[i] = s / Lm[i][i];
                }
                for (int i = 29; i >= 0; --i) {
                    float s = y[i];
                    for (int k = i + 1; k < 30; ++k) s -= Lm[k][i] * dx[k];
                    dx[i] = s / Lm[i][i];
                }
                for (int i = 0; i < 30; ++i) dx[i] = dx[i] / dsc[i];
                update_state(S, dx);
                update_state(S + 21, dx + 15);
            }
        }
        __syncthreads();
    }
    // outputs: the current camera pose, v, bias, H_full; final inliers
    int n = 0;
    for (int i = tid; i < N; i += THREADS) n += inliers[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        n += __shfl_xor_sync(0xffffffffu, n, off);
    if (lane == 0) cnt[warp] = n;
    __syncthreads();
    if (tid == 0) {
        long long s = 0;
        for (int wq = 0; wq < NWARPS; ++wq) s += cnt[wq];
        *n_inliers = s;
        for (int k = 0; k < 9; ++k) out[k] = Rcw[k];
        for (int q = 0; q < 3; ++q) {
            out[9 + q] = tcw[q];
            out[12 + q] = S[33 + q];
        }
        for (int q = 0; q < 6; ++q) out[15 + q] = S[36 + q];
    }
    for (int q = tid; q < 900; q += THREADS) out[21 + q] = H[q / 30][q % 30];
}

extern "C" int pose_inertial(const void* cst, const void* Xw,
                             const void* obs, const void* info,
                             const void* valid, const void* obs_ur, int N,
                             int n_iters, void* out,
                             void* inliers, void* n_inliers, void* stream) {
    pose_inertial_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)cst, (const float*)Xw, (const float*)obs,
        (const float*)info, (const uint8_t*)valid, (const float*)obs_ur, N,
        n_iters, (float*)out, (uint8_t*)inliers,
        (long long*)n_inliers);
    return (int)cudaGetLastError();
}
