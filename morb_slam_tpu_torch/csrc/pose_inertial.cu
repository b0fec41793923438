// K12: the per-frame visual-inertial pose optimization, every Gauss-Newton
// step and reclassification round of one call in one launch.
//
// Replaces morb_slam_tpu/optim/vi_ba.py:optimize_pose_inertial (its
// gn_step and round_body), which the visual-inertial tracker runs on every
// frame after the IMU initialization: 2 rounds x (6 steps + 1
// reclassification) + 1 final evaluation.
//
// What bounds it on an H100: latency. The call reads ~33 B per observation
// (1,200 observations: ~40 KB) and ~0.8 KB of edge constants; each step
// does ~400 flops per observation plus a few tens of kflop for the edge
// Jacobian, its products and the Cholesky. Every step needs the state the
// step before it produced, so the chain of steps, each a reduction over
// the observations followed by a dense solve, sets the time.
//
// The 15-dim system. The reference's state is 30-dim (anchor keyframe,
// current frame), but the tracker always fixes the anchor: vi_ba.py:519-522
// (anchor_fixed=True) replaces the anchor's 15 rows and columns of H by I
// and 0 and zeroes g[:15]. The system is then diag(I, H_cc): dx[:15] is
// exactly 0 (the anchor state never moves), the anchor's 15 Jacobian
// columns feed only entries that are overwritten, and the reference's
// marginal (vi_ba.py:_marginal: H_cc - H_ac^T (I + 1e-5 I)^-1 H_ac with
// H_ac = 0) is exactly the symmetrized H_cc. So this kernel evaluates only
// the current state's 15 tangents of the edge Jacobian, solves the 15x15
// system and emits H_cc as H_marg. An anchor-free caller (none exists in
// either package) would need the 30-dim form back.
//
// Design: one block of THREADS threads; the state lives in shared memory.
//  - Warp 0 (the solver warp) evaluates the inertial edge while warps
//    1.. do the visual pass: lane d < 15 runs vi_ba._edge_residual on
//    (value, derivative) pairs seeded with the current state's tangent e_d
//    (the anchor's side in plain floats, computed once per call: its
//    tangent is zero and it never moves), giving column d of Je (9 x 15);
//    lane i then forms its column of Je^T Omega and row i of H_cc and g_c.
//  - The visual warps each own a fixed stride of observations (their active
//    flags live in the `inliers` output), build residuals, the body-tangent
//    Jacobian rows J_pt [-I | hat(Xc)] and Huber weights, accumulate the 21
//    upper entries of H_v and the 6 of J^T w r, and reduce them across the
//    warp by a transposed butterfly (31 shuffles for the 27 sums).
//  - After one barrier the solver warp sums the visual warps' partials
//    (lane k takes entry k, in warp order), adds the visual block and the
//    bias random walk's current-side terms, symmetrizes, scales (Jacobi +
//    1e-6 I), factors by a right-looking Cholesky with lane i owning row i
//    (shuffles only; one reciprocal per pivot, so the substitutions
//    multiply), substitutes over 15 lanes and updates the current state,
//    21 lanes in parallel; a second barrier publishes the pose.
// Two barriers per step; a reclassification step needs none (each thread
// reclassifies only its own rows). The arithmetic follows the plain
// version's formulas; the sums run in another order than its einsums, so
// results agree to float32 rounding.
#include <cuda_runtime.h>
#include <stdint.h>

#include "imu_edge.cuh"

#define THREADS 512
#define NWARPS (THREADS / 32)
#define NVW (NWARPS - 1)           // visual warps
#define NVIS (NVW * 32)            // visual threads
#define NACC 27
#define HUBER2_MONO 5.991f
#define HUBER2_STEREO 7.815f
#define FULL 0xffffffffu

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
// plain float helpers
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

// float matrix (3x3) times dual matrix / vector
__device__ __forceinline__ void fmm(const float* A, const Dl* B, Dl* C) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                           A[3 * i + 2] * B[6 + j];
}
__device__ __forceinline__ void fmv(const float* A, const Dl* x, Dl* y) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
        y[i] = A[3 * i] * x[0] + A[3 * i + 1] * x[1] + A[3 * i + 2] * x[2];
}

// The anchor's side of vi_ba._edge_residual (imu_edge.cuh's
// edge_residual): the anchor never moves (its tangent is fixed at zero, so
// R_i exp(0) = R_i, p_i + R_i 0 = p_i, ...), so these terms are the same in
// every step and are computed once per call. Si: the anchor's [R 0, p 9,
// v 12, b 15]. A: R_i^T 0, dR_c^T 9 (the bias-corrected dR), dV_c 18,
// dP_c 21, and the constant parts of the velocity and position residuals,
// v_i + g dt 24 and p_i + dt v_i + g dt^2 / 2 27, as the dual code forms
// them.
#define A_RIT 0
#define A_DRCT 9
#define A_DVC 18
#define A_DPC 21
#define A_V 24
#define A_P 27
#define N_ANCHOR 30
__device__ void anchor_terms(const float* Si, const ImuEdge& C, float* A) {
    float dbg[3], dba[3], u[3], Eb[9], dRc[9];
    for (int q = 0; q < 3; ++q) {
        dbg[q] = Si[15 + q] - C.bias0[q];
        dba[q] = Si[18 + q] - C.bias0[3 + q];
    }
    for (int i = 0; i < 3; ++i)
        u[i] = C.JRg[3 * i] * dbg[0] + C.JRg[3 * i + 1] * dbg[1] +
               C.JRg[3 * i + 2] * dbg[2];
    exp3(u, Eb);
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            dRc[3 * i + j] = C.dR[3 * i] * Eb[j] + C.dR[3 * i + 1] * Eb[3 + j] +
                             C.dR[3 * i + 2] * Eb[6 + j];
    for (int q = 0; q < 3; ++q) {
        float v = C.dV[q], p = C.dP[q];
        v += C.JVg[3 * q] * dbg[0] + C.JVg[3 * q + 1] * dbg[1] +
             C.JVg[3 * q + 2] * dbg[2];
        v += C.JVa[3 * q] * dba[0] + C.JVa[3 * q + 1] * dba[1] +
             C.JVa[3 * q + 2] * dba[2];
        p += C.JPg[3 * q] * dbg[0] + C.JPg[3 * q + 1] * dbg[1] +
             C.JPg[3 * q + 2] * dbg[2];
        p += C.JPa[3 * q] * dba[0] + C.JPa[3 * q + 1] * dba[1] +
             C.JPa[3 * q + 2] * dba[2];
        A[A_DVC + q] = v;
        A[A_DPC + q] = p;
    }
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            A[A_RIT + 3 * i + j] = Si[3 * j + i];
            A[A_DRCT + 3 * i + j] = dRc[3 * j + i];
        }
    const float dt = C.dt;
    const float g[3] = {0.0f, 0.0f, -9.81f};
    for (int q = 0; q < 3; ++q) {
        A[A_V + q] = g[q] * dt;
        A[A_P + q] = 0.5f * g[q] * dt * dt;
    }
}

// vi_ba._edge_residual with the anchor's side from anchor_terms (A) and
// the current side on dual numbers seeded with the unit tangent e_d of the
// current state (d < 15; any other d gives the values with zero
// derivatives). Si, Sj: [R 0, p 9, v 12, b 15].
__device__ void edge_residual_current(int d, const float* Si,
                                      const float* Sj, const float* A,
                                      float dt, Dl* r) {
    Dl x[15];
#pragma unroll
    for (int q = 0; q < 15; ++q) x[q] = Dl{0.0f, q == d ? 1.0f : 0.0f};
    // current side: R_j exp(phi), p_j + R_j dp, v_j + dv
    Dl E[9], Rj[9], Rj_[9], t3[3], pj_[3], vj_[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) Rj[k] = dl(Sj[k]);
    dexp(x + 3, E);
    dmm(Rj, E, Rj_);
    fmv(Sj, x + 0, t3);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
        pj_[q] = dl(Sj[9 + q]) + t3[q];
        vj_[q] = dl(Sj[12 + q]) + x[6 + q];
    }
    Dl M1[9], M2[9];
    fmm(A + A_RIT, Rj_, M1);
    fmm(A + A_DRCT, M1, M2);
    dlog(M2, r);
    Dl a[3], b[3], uu[3], ww[3];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
        a[q] = vj_[q] - dl(Si[12 + q]) - dl(A[A_V + q]);
        b[q] = pj_[q] - dl(Si[9 + q]) - dl(dt * Si[12 + q]) -
               dl(A[A_P + q]);
    }
    fmv(A + A_RIT, a, uu);
    fmv(A + A_RIT, b, ww);
#pragma unroll
    for (int q = 0; q < 3; ++q) {
        r[3 + q] = uu[q] - dl(A[A_DVC + q]);
        r[6 + q] = ww[q] - dl(A[A_DPC + q]);
    }
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

// Transposed butterfly: v[0..31] of every lane in, the warp's sum of entry
// `lane` out (31 shuffles). Each level keeps half of the entries and
// receives the partner's partial sums of that half.
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

__global__ void __launch_bounds__(THREADS, 1)
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
    __shared__ float Anc[N_ANCHOR];      // the anchor's side of the edge
    __shared__ float Rcw[9], tcw[3];
    __shared__ float red[NVW][32];
    __shared__ float JeS[9][16], reS[9], totS[32];
    __shared__ float HS[15][16], LS[15][16], dxS[16];
    __shared__ int cnt[NWARPS];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int vt = tid - 32;   // visual thread index (warps 1..)
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
        // camera pose of the current body state
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j) Rcw[3 * i + j] = S[21 + 3 * j + i];
        for (int i = 0; i < 3; ++i)
            tcw[i] = -(Rcw[3 * i] * S[30] + Rcw[3 * i + 1] * S[31] +
                       Rcw[3 * i + 2] * S[32]);
        const ImuEdge E{C[C_DT], C + C_DR, C + C_DV, C + C_DP,
                        C + C_JRG, C + C_JVG, C + C_JVA, C + C_JPG,
                        C + C_JPA, C + C_BIAS0};
        anchor_terms(S, E, Anc);
    }
    if (warp > 0)
        for (int i = vt; i < N; i += NVIS) inliers[i] = valid[i] ? 1 : 0;
    __syncthreads();

    // 2 rounds x (n_iters steps + reclassification), then the final step
    const int total = 2 * (n_iters + 1) + 1;
    for (int step = 0; step < total; ++step) {
        const int in_round = step % (n_iters + 1);
        const bool final_step = step == total - 1;
        const bool reclass = !final_step && in_round == n_iters;
        if (reclass) {
            // each visual thread reclassifies its own rows: no barrier
            if (warp > 0)
                for (int i = vt; i < N; i += NVIS) {
                    const Row e = eval_row(Rcw, tcw, Xw, obs, info, obs_ur,
                                           base, i);
                    inliers[i] = (valid[i] && e.chi2 < e.th) ? 1 : 0;
                }
            continue;
        }
        float h[15], gi = 0.0f;     // the solver warp: row `lane` of H_cc
        if (warp > 0) {
            // ---- visual terms on the current state's dims 0:6
            float acc[32];
#pragma unroll
            for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
            for (int i = vt; i < N; i += NVIS) {
                if (!inliers[i]) continue;
                const Row e = eval_row(Rcw, tcw, Xw, obs, info, obs_ur, base,
                                       i);
                if (!(e.z > 0.0f)) continue;
                const float hub = e.chi2 <= e.th
                    ? 1.0f : sqrtf(e.th / fmaxf(e.chi2, 1e-12f));
                const float w = info[i] * hub;
                const float iz2 = e.iz * e.iz;
                add_row(acc, w, e.rx, e.iz, 0.0f, -e.x * iz2, e.x, e.y, e.z);
                add_row(acc, w, e.ry, 0.0f, e.iz, -e.y * iz2, e.x, e.y, e.z);
                if (e.stereo)
                    add_row(acc, w, e.rur, e.iz, 0.0f, -(e.x - base) * iz2,
                            e.x, e.y, e.z);
            }
            red[warp - 1][lane] = warp_transpose_sum(acc, lane);
        } else {
            // ---- the inertial edge Jacobian, one current tangent per lane
            if (lane < 15) {
                Dl r[9];
                edge_residual_current(lane, S, S + 21, Anc, C[C_DT], r);
#pragma unroll
                for (int a = 0; a < 9; ++a) JeS[a][lane] = r[a].d;
                if (lane == 0)
#pragma unroll
                    for (int a = 0; a < 9; ++a) reS[a] = r[a].v;
            }
            __syncwarp();
            // column `lane` of Je^T Omega, row `lane` of H_cc, g_c
            float jw[9];
#pragma unroll
            for (int b = 0; b < 9; ++b) {
                float s = 0.0f;
#pragma unroll
                for (int a = 0; a < 9; ++a)
                    s += JeS[a][lane < 15 ? lane : 0] * C[C_INFO + 9 * a + b];
                jw[b] = s;
            }
#pragma unroll
            for (int j = 0; j < 15; ++j) {
                float s = 0.0f;
#pragma unroll
                for (int b = 0; b < 9; ++b) s += jw[b] * JeS[b][j];
                h[j] = s;
            }
            float s = 0.0f;
#pragma unroll
            for (int b = 0; b < 9; ++b) s += jw[b] * reS[b];
            gi = -s;
        }
        __syncthreads();
        if (warp == 0) {
            // the visual warps' partials, entry `lane`, in warp order
            if (lane < NACC) {
                float s = 0.0f;
                for (int wq = 0; wq < NVW; ++wq) s += red[wq][lane];
                totS[lane] = s;
            }
            __syncwarp();
            if (lane < 6) {
                // visual block on dims 0:6 (upper-triangle index of (p, q))
#pragma unroll
                for (int q = 0; q < 6; ++q) {
                    const int p0 = lane < q ? lane : q, q0 = lane < q ? q : lane;
                    const int k = p0 * 6 - p0 * (p0 - 1) / 2 + (q0 - p0);
                    h[q] += totS[k];
                }
                gi += -totS[21 + lane];
            }
            if (lane >= 9 && lane < 15) {
                // bias random walk, the current side (the anchor's rows and
                // its coupling are fixed away)
                const int q = lane - 9;
                const float rw = C[C_RW + q];
                const float rr = S[36 + q] - S[15 + q];
#pragma unroll
                for (int j = 9; j < 15; ++j)
                    if (j == lane) h[j] += rw;
                gi += -rw * rr;
            }
            // symmetrize through shared memory
            if (lane < 15)
#pragma unroll
                for (int j = 0; j < 15; ++j) HS[lane][j] = h[j];
            __syncwarp();
            const int li = lane < 15 ? lane : 0;
#pragma unroll
            for (int j = 0; j < 15; ++j) h[j] = 0.5f * (h[j] + HS[j][li]);
            if (final_step) {
                if (lane < 15)
#pragma unroll
                    for (int j = 0; j < 15; ++j) out[21 + 15 * lane + j] = h[j];
            } else {
                // Jacobi scaling + 1e-6 I, by the reciprocals of the
                // scales. Lanes 15-31 hold zero rows, and the only
                // divisions are of uniform or scale values: an operand off
                // the fast path of a division on any lane stalls the warp
                const bool row = lane < 15;
                float hii = 0.0f;
#pragma unroll
                for (int j = 0; j < 15; ++j)
                    if (j == lane) hii = h[j];
                const float inv_di = 1.0f / sqrtf(fmaxf(hii, 1e-8f));
                float a[15];
#pragma unroll
                for (int j = 0; j < 15; ++j) {
                    const float inv_dj = __shfl_sync(FULL, inv_di, j);
                    a[j] = row ? h[j] * inv_di * inv_dj +
                                     (j == lane ? 1e-6f : 0.0f)
                               : 0.0f;
                }
                // right-looking Cholesky, lane i owns row i: a[j] <- L[i][j];
                // every lane takes the pivot's reciprocal square root once
                // (the pivot is a_jj times it), lane j keeps the reciprocal
                // for the substitutions
                float inv_own = 0.0f;
#pragma unroll
                for (int j = 0; j < 15; ++j) {
                    const float ajj = __shfl_sync(FULL, a[j], j);
                    const float inv = rsqrtf(ajj);
                    const float piv = ajj * inv;
                    const float l = a[j] * inv;
                    if (lane == j) inv_own = inv;
                    a[j] = lane == j ? piv : l;
#pragma unroll
                    for (int k = j + 1; k < 15; ++k) {
                        const float lk = __shfl_sync(FULL, l, k);
                        if (lane > j) a[k] -= l * lk;
                    }
                }
                // forward: L y = g / d, column by column
                float rr = row ? gi * inv_di : 0.0f, y = 0.0f;
#pragma unroll
                for (int j = 0; j < 15; ++j) {
                    const float yj = __shfl_sync(FULL, rr * inv_own, j);
                    if (lane == j) y = yj;
                    if (lane > j) rr -= a[j] * yj;
                }
                // backward: L^T x = y; lane i reads column i of L
                if (row)
#pragma unroll
                    for (int j = 0; j < 15; ++j) LS[lane][j] = a[j];
                __syncwarp();
                float xi = 0.0f;
#pragma unroll
                for (int j = 14; j >= 0; --j) {
                    const float xj = __shfl_sync(FULL, y * inv_own, j);
                    if (lane == j) xi = xj;
                    if (lane < j) y -= LS[j][li] * xj;
                }
                if (lane < 15) dxS[lane] = xi * inv_di;
                __syncwarp();
                // the current state: R <- R exp(phi), p <- p + R dp (old
                // R), v += dv, b += db; lane k owns S[21 + k]
                float nv = 0.0f;
                if (lane < 9) {
                    float Ex[9];
                    exp3(dxS + 3, Ex);
                    const int i = lane / 3, j = lane % 3;
                    nv = S[21 + 3 * i] * Ex[j] + S[21 + 3 * i + 1] * Ex[3 + j] +
                         S[21 + 3 * i + 2] * Ex[6 + j];
                } else if (lane < 12) {
                    const int i = lane - 9;
                    const float s2 = S[21 + 3 * i] * dxS[0] +
                                     S[21 + 3 * i + 1] * dxS[1] +
                                     S[21 + 3 * i + 2] * dxS[2];
                    nv = S[30 + i] + s2;
                } else if (lane < 21) {
                    nv = S[21 + lane] + dxS[6 + lane - 12];
                }
                __syncwarp();
                if (lane < 21) S[21 + lane] = nv;
                __syncwarp();
                // camera pose of the new current state
                if (lane < 9) {
                    const int i = lane / 3, j = lane % 3;
                    Rcw[3 * i + j] = S[21 + 3 * j + i];
                } else if (lane < 12) {
                    const int i = lane - 9;
                    tcw[i] = -(S[21 + i] * S[30] + S[24 + i] * S[31] +
                               S[27 + i] * S[32]);
                }
            }
        }
        __syncthreads();
    }
    // outputs: the current camera pose, v, bias (H_marg written by the
    // final step); final inliers
    int n = 0;
    for (int i = tid; i < N; i += THREADS) n += inliers[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        n += __shfl_xor_sync(FULL, n, off);
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
