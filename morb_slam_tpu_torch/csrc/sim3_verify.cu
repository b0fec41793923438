// K18: the guided Sim(3) verification of a loop or merge candidate: the
// window-gated descriptor match through the RANSAC Sim(3), then its
// 7-dof Gauss-Newton refinement.
//
// Replaces morb_slam_tpu/pipeline/loop_closing.py:guided_sim3_verify
// (window_match, :104-124, and the refinement, :126-175), which the loop
// closer runs on every candidate that passed the RANSAC and the merge on
// every stashed contact. The plain versions are
// pipeline/loop_closing.py:window_match_plain and sim3_refine_plain.
//
// What bounds it on an H100: latency. The inputs are two keyframes'
// features (~100 B each: descriptor, point, observation, octave, flags;
// ~0.24 MB at F = 1200) and the outputs a few hundred bytes. The match
// costs ~30 operations a pair (the window gate, 8 XOR + 8 popcount) in
// each direction, ~90 Mop at 1200 x 1200; the refinement 12 passes over
// F features of 8 evaluations (the values and 7 tangents) of the two
// residuals, ~20 Mflop, then 10 dense 7 x 7 solves. The plain version is
// hundreds of small launches and a host-visible solve per step; the
// reference program forms the F x F gate and distance matrices.
//
// Design: two calls, no float atomics.
//  - sim3_window_match, three kernels. Rows: one warp per candidate
//    feature, 8 per block; every lane projects the feature's point through
//    (s0, R0, t0) (sums left to right, no FMA: the plain version's
//    rounding), lane 0 keeps (x, y, radius^2, flag) in scratch; the block
//    stages the keyframe's descriptors, observations and flags in shared
//    memory, CHUNK at a time, and each lane keeps a running (best, index,
//    second) over its columns, merged by a butterfly of shuffles
//    (distance, then column: the first column wins ties) as K3 does.
//    Columns: the same per keyframe feature over the candidate's rows
//    (the cross check's argmin, first row on ties). A last kernel applies
//    TH_HIGH, the ratio 1 test (best < second) and the cross check.
//  - sim3_refine, one launch of a cluster of CL (8) blocks of RB threads,
//    all in double. The sums of H and g keep the order of the earlier
//    one-block form, 128 strided slots (slot t sums features t, t + 128,
//    ..., forward then backward, skipping inactive ones), then the 128
//    slots in order; block b owns slots 16 b .. 16 b + 15, so it alone
//    touches its features. Per Gauss-Newton step threads 0-7 evaluate
//    (s, R, t) and its inverse on dual numbers seeded with tangent 0-6
//    (7: values only), into shared memory.
//    Then, a chunk of MR rows of features at a time, each thread
//    evaluates one (feature, direction, tangent) residual, the 7 tangents
//    of a feature-direction on 7 threads, into shared memory (an inactive
//    pair's terms as zeros), and a chain per (slot, entry), one or two a
//    thread, adds its slot's terms in the old order (r.v does not depend
//    on the tangent; an added +0.0 leaves the sum's bits as skipping the
//    pair did: a sum that starts at +0.0 is never -0.0). The blocks share
//    their partials through distributed shared memory after
//    cluster.sync() (two buffers, so one sync a step); every block sums
//    the 128 partials of each entry in slot order and solves
//    (H + 1e-4 I) dx = g by the same Cholesky on its thread 0, so every
//    block holds the same x without a broadcast. A candidate seen from near the
//    keyframe's own position leaves the scale unobservable (on the
//    inertial drifted map H's eigenvalues span 1.4e-9 to 2.9e7): in
//    float32 the rounding of the Jacobians alone moves s by ~3e-3 there,
//    in double the result follows the inputs. After each round of 5 steps
//    every feature is reclassified at chi2 9.21 by its own block; the last
//    round's forward count is n_good, an integer sum into block 0's shared
//    memory. (s, R, t) and n_good stay on the device. The plain version
//    repeats every operation in this order; the build has no FMA
//    contraction.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// Forward-mode dual numbers in double (value, one tangent): dual.cuh's
// operations and so3_exp at the precision the refinement needs (a
// candidate seen from near the keyframe's position leaves the scale
// direction to the 1e-4 damping alone; float32 rounding of the Jacobians
// moves s by ~3e-3 there). The plain version repeats each in its order.
struct Dd {
    double v, d;
};
__device__ __forceinline__ Dd dd(double v) { return Dd{v, 0.0}; }
__device__ __forceinline__ Dd operator+(Dd a, Dd b) {
    return Dd{a.v + b.v, a.d + b.d};
}
__device__ __forceinline__ Dd operator-(Dd a, Dd b) {
    return Dd{a.v - b.v, a.d - b.d};
}
__device__ __forceinline__ Dd operator-(Dd a) { return Dd{-a.v, -a.d}; }
__device__ __forceinline__ Dd operator*(Dd a, Dd b) {
    return Dd{a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ __forceinline__ Dd operator*(double s, Dd a) {
    return Dd{s * a.v, s * a.d};
}
__device__ __forceinline__ Dd operator/(Dd a, Dd b) {
    return Dd{a.v / b.v, (a.d * b.v - a.v * b.d) / (b.v * b.v)};
}

// so3_exp(w) (row-major), lie.py's form with its |theta| < 1e-4 series
__device__ void dexp(const Dd* w, Dd* R) {
    const Dd n2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
    const Dd n2e = n2 + dd(1e-24);
    const double sq = sqrt(n2e.v);
    const Dd th = Dd{sq, n2e.d / (2.0 * sq)};
    const Dd th2 = th * th;
    Dd a, b;
    if (fabs(th.v) < 1e-4) {
        a = dd(1.0) - (1.0 / 6.0) * th2;
        b = dd(0.5) - (1.0 / 24.0) * th2;
    } else {
        const double sn = sin(th.v), cs = cos(th.v);
        a = Dd{sn, cs * th.d} / th;
        b = (dd(1.0) - Dd{cs, -sn * th.d}) / th2;
    }
    const Dd W[9] = {dd(0.0), -w[2], w[1], w[2], dd(0.0), -w[0], -w[1],
                     w[0], dd(0.0)};
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            const Dd W2 = w[i] * w[j] - (i == j ? n2 : dd(0.0));
            R[3 * i + j] = dd(i == j ? 1.0 : 0.0) + a * W[3 * i + j] +
                           b * W2;
        }
}

#define BIG (1 << 20)
#define TH_HIGH 100
#define WARPS 8
#define CHUNK 256
#define RT 128
#define CHI2 9.21
// the refinement: blocks in its cluster, threads a block, feature rows (of
// RT features) a chunk, sums a slot (28 of H's upper triangle, 7 of g)
#define CL 8
#define RB 512
#define MR 10
#define NENT 35
#define SLOTS (RT / CL)
#define FD (MR * SLOTS * 32 > RT * NENT ? MR * SLOTS * 32 : RT * NENT)
static_assert((SLOTS * NENT) % 2 == 0, "a block's partials in double2");
static_assert(SLOTS * NENT <= 2 * RB, "at most two chains a thread");

struct Col {
    uint4 d0, d1;
    float x, y;
    int ok;
};

__device__ __forceinline__ int hamming8(uint4 a0, uint4 a1, uint4 b0,
                                        uint4 b1) {
    return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
           __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
           __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

// The window gate of one pair, as window_match_plain: d2 < rad^2 (both
// computed without contraction), the row's z and validity flag, the
// column's validity.
__device__ __forceinline__ bool in_window(const float4 row, float x, float y,
                                          int col_ok) {
    const float dx = row.x - x, dy = row.y - y;
    return row.w != 0.0f && col_ok && dx * dx + dy * dy < row.z;
}

__global__ void __launch_bounds__(WARPS * 32)
window_rows_kernel(const uint4* __restrict__ desc2,
                   const uint4* __restrict__ desc1,
                   const float* __restrict__ X2c,
                   const uint8_t* __restrict__ ok2,
                   const int* __restrict__ oct2,
                   const float* __restrict__ xn1,
                   const uint8_t* __restrict__ valid1,
                   const float* __restrict__ sim, int n2, int n1,
                   float rad_coef, float scale, float4* __restrict__ rows,
                   int* __restrict__ best_out, int* __restrict__ idx_out,
                   int* __restrict__ second_out) {
    __shared__ Col sc[CHUNK];
    const int lane = threadIdx.x & 31;
    const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const bool active = i < n2;
    uint4 a0 = make_uint4(0, 0, 0, 0), a1 = a0;
    float4 row = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (active) {
        a0 = desc2[2 * (size_t)i];
        a1 = desc2[2 * (size_t)i + 1];
        const float* X = X2c + 3 * (size_t)i;
        const float s = sim[0];
        const float* R = sim + 1;
        const float* t = sim + 10;
        float Xp[3];
        for (int k = 0; k < 3; ++k)
            Xp[k] = s * (R[3 * k] * X[0] + R[3 * k + 1] * X[1] +
                         R[3 * k + 2] * X[2]) + t[k];
        const float zs = fabsf(Xp[2]) < 1e-6f ? 1e-6f : Xp[2];
        const float rad = rad_coef * powf(scale, (float)oct2[i]);
        row = make_float4(Xp[0] / zs, Xp[1] / zs, rad * rad,
                          (ok2[i] && Xp[2] > 0.05f) ? 1.0f : 0.0f);
        if (lane == 0) rows[i] = row;
    }
    int best = INT_MAX, bidx = INT_MAX, second = INT_MAX;
    for (int c0 = 0; c0 < n1; c0 += CHUNK) {
        const int nc = min(CHUNK, n1 - c0);
        __syncthreads();
        for (int t = threadIdx.x; t < nc; t += blockDim.x) {
            const int j = c0 + t;
            Col c;
            c.d0 = desc1[2 * (size_t)j];
            c.d1 = desc1[2 * (size_t)j + 1];
            c.x = xn1[2 * (size_t)j];
            c.y = xn1[2 * (size_t)j + 1];
            c.ok = valid1[j];
            sc[t] = c;
        }
        __syncthreads();
        if (!active) continue;
        for (int t = lane; t < nc; t += 32) {
            const Col& c = sc[t];
            const int d = in_window(row, c.x, c.y, c.ok)
                              ? hamming8(a0, a1, c.d0, c.d1) : BIG;
            if (d < best) {
                second = best;
                best = d;
                bidx = c0 + t;
            } else if (d < second) {
                second = d;
            }
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const int ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
        const int os = __shfl_xor_sync(0xffffffffu, second, off);
        if (ob < best || (ob == best && oi < bidx)) {
            second = min(os, best);
            best = ob;
            bidx = oi;
        } else {
            second = min(second, ob);
        }
    }
    if (active && lane == 0) {
        best_out[i] = best;
        idx_out[i] = bidx;
        second_out[i] = min(second, BIG);
    }
}

__global__ void __launch_bounds__(WARPS * 32)
window_cols_kernel(const uint4* __restrict__ desc2,
                   const uint4* __restrict__ desc1,
                   const float4* __restrict__ rows,
                   const float* __restrict__ xn1,
                   const uint8_t* __restrict__ valid1, int n2, int n1,
                   int* __restrict__ col_out) {
    __shared__ uint4 sd[2 * CHUNK];
    __shared__ float4 sr[CHUNK];
    const int lane = threadIdx.x & 31;
    const int j = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const bool active = j < n1;
    uint4 b0 = make_uint4(0, 0, 0, 0), b1 = b0;
    float x = 0.0f, y = 0.0f;
    int ok = 0;
    if (active) {
        b0 = desc1[2 * (size_t)j];
        b1 = desc1[2 * (size_t)j + 1];
        x = xn1[2 * (size_t)j];
        y = xn1[2 * (size_t)j + 1];
        ok = valid1[j];
    }
    int best = INT_MAX, bidx = INT_MAX;
    for (int r0 = 0; r0 < n2; r0 += CHUNK) {
        const int nr = min(CHUNK, n2 - r0);
        __syncthreads();
        for (int t = threadIdx.x; t < nr; t += blockDim.x) {
            sd[2 * t] = desc2[2 * (size_t)(r0 + t)];
            sd[2 * t + 1] = desc2[2 * (size_t)(r0 + t) + 1];
            sr[t] = rows[r0 + t];
        }
        __syncthreads();
        if (!active) continue;
        for (int t = lane; t < nr; t += 32) {
            const int d = in_window(sr[t], x, y, ok)
                              ? hamming8(sd[2 * t], sd[2 * t + 1], b0, b1)
                              : BIG;
            if (d < best) {
                best = d;
                bidx = r0 + t;
            }
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const int ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
        if (ob < best || (ob == best && oi < bidx)) {
            best = ob;
            bidx = oi;
        }
    }
    if (active && lane == 0) col_out[j] = bidx;
}

// hamming.match_nn's acceptance: TH_HIGH, best < 1.0 * second, the cross
// check and the row's own validity
__global__ void window_final_kernel(const int* __restrict__ best,
                                    const int* __restrict__ bidx,
                                    const int* __restrict__ second,
                                    const int* __restrict__ col,
                                    const uint8_t* __restrict__ ok2, int n2,
                                    int* __restrict__ idx) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n2) return;
    const int j = bidx[i];
    const bool ok = best[i] <= TH_HIGH &&
                    (float)best[i] < (float)second[i] && col[j] == i &&
                    ok2[i];
    idx[i] = ok ? j : -1;
}

// (s, R, t) = (s0 exp(x0), R0 exp(x1..3), t0 + x4..6) and its inverse on
// dual numbers with tangent `lane` (>= 7: values only): 26 duals
// [s, R (9), t (3), si, Ri (9), ti (3)]
__device__ void sim3_duals(int lane, const double* x, const float* sim,
                           Dd* out) {
    Dd xd[7];
    for (int q = 0; q < 7; ++q) xd[q] = Dd{x[q], q == lane ? 1.0 : 0.0};
    const double ex = exp(xd[0].v);
    const double s0 = sim[0];
    const Dd s = Dd{s0 * ex, s0 * ex * xd[0].d};
    Dd E[9], R0[9], R[9];
    dexp(xd + 1, E);
    for (int k = 0; k < 9; ++k) R0[k] = dd(sim[1 + k]);
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            R[3 * i + j] = R0[3 * i] * E[j] + R0[3 * i + 1] * E[3 + j] +
                           R0[3 * i + 2] * E[6 + j];
    Dd t[3];
    for (int q = 0; q < 3; ++q) t[q] = dd(sim[10 + q]) + xd[4 + q];
    // sim3_inv: (1 / s, R^T, -(1 / s) R^T t)
    const Dd si = dd(1.0) / s;
    Dd Ri[9], Rt[3];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) Ri[3 * i + j] = R[3 * j + i];
    for (int i = 0; i < 3; ++i)
        Rt[i] = Ri[3 * i] * t[0] + Ri[3 * i + 1] * t[1] + Ri[3 * i + 2] * t[2];
    out[0] = s;
    for (int k = 0; k < 9; ++k) out[1 + k] = R[k];
    for (int q = 0; q < 3; ++q) out[10 + q] = t[q];
    out[13] = si;
    for (int k = 0; k < 9; ++k) out[14 + k] = Ri[k];
    for (int q = 0; q < 3; ++q) out[23 + q] = -(si * Rt[q]);
}

// one reprojection residual (2) of point X through the Sim(3) duals T
// (s at T[0], R at T[1], t at T[10]) against observation (u, v)
__device__ __forceinline__ void reproj(const Dd* T, const float* X, float u,
                                       float v, Dd* r) {
    Dd P[3];
    for (int k = 0; k < 3; ++k)
        P[k] = T[0] * (T[1 + 3 * k] * dd(X[0]) + T[2 + 3 * k] * dd(X[1]) +
                       T[3 + 3 * k] * dd(X[2])) + T[10 + k];
    const Dd z = fabs(P[2].v) < 1e-6 ? dd(1e-6) : P[2];
    r[0] = P[0] / z - dd(u);
    r[1] = P[1] / z - dd(v);
}

// The refinement's cluster: CL blocks on neighbouring SMs, block b owning
// the partial-sum slots SLOTS b .. SLOTS b + SLOTS - 1 of the RT slots
// (slot t sums features t, t + RT, ...). Shared memory of one block:
struct RefineShared {
    Dd T[8][26];                 // (s, R, t) and its inverse a tangent
    // a chunk's residuals and Jacobians (16 doubles a feature-direction:
    // J0[7], J1[7], r0, r1), then the cluster's RT x NENT partial sums
    alignas(16) double fd[FD];
    alignas(16) double part[2][SLOTS * NENT];  // two passes apart
    double sums[NENT];
    double x[7];
    float fw[MR * SLOTS * 2];    // a chunk's feature-directions' weights
    int good;                    // block 0: the last round's forward inliers
};

// One partial sum: slot SLOTS b + j of the block, entry q of the 28 + 7
// (H's (a, b) entry: J0a J0b + J1a J1b; g's a: J0a r0 + J1a r1), as the
// offsets of its factors in a feature-direction's record.
struct Chain {
    int j, a, i1, i2;
};

__device__ Chain chain_of(int w) {
    if (w >= SLOTS * NENT) return Chain{SLOTS, 0, 0, 0};   // none
    const int q = w % NENT;
    if (q >= 28) return Chain{w / NENT, q - 28, 14, 15};
    int a = 0, r = q;
    while (r >= 7 - a) {
        r -= 7 - a;
        ++a;
    }
    return Chain{w / NENT, a, a + r, 7 + a + r};
}

// a feature-direction's term of a partial sum, as the one-block form
// formed it: w (Ja Jb + ...), no FMA
__device__ __forceinline__ double term(const RefineShared& S, int f,
                                       const Chain& c) {
    const double* o = S.fd + 16 * f;
    const double w = S.fw[f];
    return w * (o[c.a] * o[c.i1] + o[7 + c.a] * o[c.i2]);
}

// (H + 1e-4 I) dx = g by Cholesky in double, then x -= dx: the one-block
// form's thread-0 solve, operation for operation (its chain of roots and
// divisions sets the time; spreading a column over lanes did not shorten
// it)
__device__ void cholesky_step(RefineShared& S) {
    double L[7][7], y[7];
    int q = 0;
    for (int a1 = 0; a1 < 7; ++a1)
        for (int b1 = a1; b1 < 7; ++b1) {
            L[b1][a1] = S.sums[q];
            L[a1][b1] = S.sums[q++];
        }
    for (int a1 = 0; a1 < 7; ++a1) L[a1][a1] += 1e-4;
    for (int j = 0; j < 7; ++j) {
        double d = L[j][j];
        for (int k = 0; k < j; ++k) d -= L[j][k] * L[j][k];
        d = sqrt(fmax(d, 1e-300));
        L[j][j] = d;
        for (int i = j + 1; i < 7; ++i) {
            double v = L[i][j];
            for (int k = 0; k < j; ++k) v -= L[i][k] * L[j][k];
            L[i][j] = v / d;
        }
    }
    for (int i = 0; i < 7; ++i) {
        double v = S.sums[28 + i];
        for (int k = 0; k < i; ++k) v -= L[i][k] * y[k];
        y[i] = v / L[i][i];
    }
    for (int i = 6; i >= 0; --i) {
        double v = y[i];
        for (int k = i + 1; k < 7; ++k) v -= L[k][i] * y[k];
        y[i] = v / L[i][i];
    }
    for (int i = 0; i < 7; ++i) S.x[i] = S.x[i] - y[i];
}

__global__ void __launch_bounds__(RB, 1)
refine_kernel(const float* __restrict__ X2c, const float* __restrict__ X1o,
              const float* __restrict__ xn1j, const float* __restrict__ xn2,
              const float* __restrict__ info1,
              const uint8_t* __restrict__ pair_ok,
              const uint8_t* __restrict__ has_inv,
              const float* __restrict__ sim, int n,
              uint8_t* __restrict__ act, float* __restrict__ out,
              int* __restrict__ n_good) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    RefineShared& S = *reinterpret_cast<RefineShared*>(smem_raw);
    cg::cluster_group cluster = cg::this_cluster();
    const int b = (int)cluster.block_rank();
    const int tid = threadIdx.x, lane = tid & 31;
    uint8_t* act_f = act;
    uint8_t* act_b = act + n;
    const int rows = (n + RT - 1) / RT;
    // this block's features i = RT m + SLOTS b + j; only it touches them
    for (int e = tid; e < rows * SLOTS; e += RB) {
        const int i = RT * (e / SLOTS) + SLOTS * b + e % SLOTS;
        if (i < n) {
            act_f[i] = pair_ok[i];
            act_b[i] = has_inv[i];
        }
    }
    if (tid < 7) S.x[tid] = 0.0;
    if (tid == 0) S.good = 0;
    // this thread's chains tid and tid + RB (where below SLOTS NENT)
    const Chain ch0 = chain_of(tid), ch1 = chain_of(tid + RB);
    __syncthreads();
    int buf = 0;
    for (int round = 0; round < 2; ++round) {
        for (int step = 0; step < 6; ++step) {
            // steps 0-4 are Gauss-Newton steps; step 5 reclassifies
            const bool gn = step < 5;
            if (gn ? tid < 8 : tid == 7) sim3_duals(tid, S.x, sim, S.T[tid]);
            __syncthreads();
            if (!gn) {
                int c = 0;
                for (int e = tid; e < rows * SLOTS * 2; e += RB) {
                    const int dir = e & 1;
                    const int i = RT * (e / (2 * SLOTS)) + SLOTS * b +
                                  (e >> 1) % SLOTS;
                    if (i >= n || !(dir == 0 ? pair_ok[i] : has_inv[i]))
                        continue;
                    const float* X = (dir == 0 ? X2c : X1o) + 3 * (size_t)i;
                    const float* ob = (dir == 0 ? xn1j : xn2) + 2 * (size_t)i;
                    Dd r[2];
                    reproj(S.T[7] + (dir == 0 ? 0 : 13), X, ob[0], ob[1], r);
                    const double w = info1[i];
                    const bool in =
                        (r[0].v * r[0].v + r[1].v * r[1].v) * w < CHI2;
                    (dir == 0 ? act_f : act_b)[i] = in;
                    if (dir == 0) c += in;
                }
                if (round == 1) {
                    c = (int)__reduce_add_sync(0xffffffffu, (unsigned)c);
                    if (lane == 0 && c)
                        atomicAdd(cluster.map_shared_rank(&S.good, 0), c);
                }
                __syncthreads();
                continue;
            }
            double acc0 = 0.0, acc1 = 0.0;
            for (int m0 = 0; m0 < rows; m0 += MR) {
                const int mr = min(MR, rows - m0);
                // a thread a (feature, direction, tangent) evaluation
                for (int e = tid; e < mr * SLOTS * 2 * 7; e += RB) {
                    const int f = e / 7, d = e - 7 * f, dir = f & 1;
                    const int i = RT * (m0 + f / (2 * SLOTS)) + SLOTS * b +
                                  (f >> 1) % SLOTS;
                    const bool on = i < n && (dir == 0 ? act_f : act_b)[i];
                    double* o = S.fd + 16 * f;
                    if (d == 0) S.fw[f] = on ? info1[i] : 0.0f;
                    if (!on) {
                        // zero terms: the chains add +0.0, which leaves
                        // their sums' bits as skipping the pair did
                        o[d] = 0.0;
                        o[7 + d] = 0.0;
                        if (d == 0) o[14] = o[15] = 0.0;
                        continue;
                    }
                    const float* X = (dir == 0 ? X2c : X1o) + 3 * (size_t)i;
                    const float* ob = (dir == 0 ? xn1j : xn2) + 2 * (size_t)i;
                    Dd r[2];
                    reproj(S.T[d] + (dir == 0 ? 0 : 13), X, ob[0], ob[1], r);
                    o[d] = r[0].d;
                    o[7 + d] = r[1].d;
                    if (d == 0) {
                        o[14] = r[0].v;
                        o[15] = r[1].v;
                    }
                }
                __syncthreads();
                // each (slot, entry) adds its features in refine order
                for (int mm = 0; mm < mr; ++mm) {
                    for (int dir = 0; dir < 2; ++dir) {
                        if (ch0.j < SLOTS)
                            acc0 += term(S, 2 * (SLOTS * mm + ch0.j) + dir,
                                         ch0);
                        if (ch1.j < SLOTS)
                            acc1 += term(S, 2 * (SLOTS * mm + ch1.j) + dir,
                                         ch1);
                    }
                }
                __syncthreads();
            }
            if (ch0.j < SLOTS) S.part[buf][tid] = acc0;
            if (ch1.j < SLOTS) S.part[buf][tid + RB] = acc1;
            cluster.sync();
            // every block sums all RT slots' partials in slot order
            for (int e = tid; e < RT * NENT / 2; e += RB) {
                const int owner = 2 * e / (SLOTS * NENT);
                const double2* src = reinterpret_cast<const double2*>(
                    cluster.map_shared_rank(S.part[buf], owner));
                reinterpret_cast<double2*>(S.fd)[e] =
                    src[e - owner * (SLOTS * NENT / 2)];
            }
            __syncthreads();
            if (tid < NENT) {
                double s = 0.0;
                for (int t = 0; t < RT; ++t) s += S.fd[NENT * t + tid];
                S.sums[tid] = s;
            }
            __syncthreads();
            if (tid == 0) cholesky_step(S);
            __syncthreads();
            buf ^= 1;
        }
    }
    // no block leaves while another may read its partials; block 0 holds
    // every block's count
    cluster.sync();
    if (b == 0 && tid == 0) {
        n_good[0] = S.good;
        sim3_duals(7, S.x, sim, S.T[0]);
        for (int k = 0; k < 13; ++k) out[k] = (float)S.T[0][k].v;
    }
}

extern "C" int sim3_window_match(
    const void* desc2, const void* desc1, const void* X2c, const void* ok2,
    const void* oct2, const void* xn1, const void* valid1, const void* sim,
    int n2, int n1, float rad_coef, float scale, void* rows, void* best,
    void* bidx, void* second, void* col, void* idx, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    window_rows_kernel<<<(n2 + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
        (const uint4*)desc2, (const uint4*)desc1, (const float*)X2c,
        (const uint8_t*)ok2, (const int*)oct2, (const float*)xn1,
        (const uint8_t*)valid1, (const float*)sim, n2, n1, rad_coef, scale,
        (float4*)rows, (int*)best, (int*)bidx, (int*)second);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    window_cols_kernel<<<(n1 + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
        (const uint4*)desc2, (const uint4*)desc1, (const float4*)rows,
        (const float*)xn1, (const uint8_t*)valid1, n2, n1, (int*)col);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    window_final_kernel<<<(n2 + 127) / 128, 128, 0, s>>>(
        (const int*)best, (const int*)bidx, (const int*)second,
        (const int*)col, (const uint8_t*)ok2, n2, (int*)idx);
    return (int)cudaGetLastError();
}

extern "C" int sim3_refine(const void* X2c, const void* X1o, const void* xn1j,
                           const void* xn2, const void* info1,
                           const void* pair_ok, const void* has_inv,
                           const void* sim, int n, void* act, void* out,
                           void* n_good, void* stream) {
    const int smem = (int)sizeof(RefineShared);
    int rc = (int)cudaFuncSetAttribute(
        refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc) return rc;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(CL);
    cfg.blockDim = dim3(RB);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = CL;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    rc = (int)cudaLaunchKernelEx(
        &cfg, refine_kernel, (const float*)X2c, (const float*)X1o,
        (const float*)xn1j, (const float*)xn2, (const float*)info1,
        (const uint8_t*)pair_ok, (const uint8_t*)has_inv, (const float*)sim,
        n, (uint8_t*)act, (float*)out, (int*)n_good);
    if (rc) return rc;
    return (int)cudaGetLastError();
}
