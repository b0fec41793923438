// K14: the global BA's Schur-complement solve by preconditioned conjugate
// gradients, with the implicit Schur product as two passes over the
// observations and the coupling held per observation (Wpl (O, 6, 3), K4's
// per-observation mode):
//
//   landmark pass  y_l   = lm_opt_l Hll_inv_l (c_l - sum_o Wpl_o^T x'[kf_o])
//   keyframe pass  out_k = kf_opt_k (a_k - sum_o Wpl_o y[lm_o])
//
// with x' = kf_opt x, and a_k = Hpp_k x'_k or a given vector; without c
// the landmark pass gives + sum_o Wpl_o^T x'[kf_o]. S x is the landmark
// pass (no c) then the keyframe pass (a = Hpp x'); the right-hand side
// bp - B Hll^-1 bl is the keyframe pass alone (a = bp, y = Hll^-1 bl); the
// back-substitution Hll^-1 (bl - B^T dxp) is the landmark pass with c = bl.
//
// Replaces morb_slam_tpu/optim/ba.py:ba_solve_pcg's solve: S_matvec (two
// gather + segment_sum passes per CG iteration), its two half-passes for
// the right-hand side and the back-substitution, and the CG loop around
// them (a lax.scan of 40 iterations per LM step). The plain versions
// (gathers + index_add_, the torch loop) are in optim/ba.py.
//
// What bounds it on an H100: operations, then bytes. A solve reads every
// active observation's 72-byte block and its ids (~88 B), the segment
// starts and the per-keyframe and per-landmark blocks once (~9 MB at the
// loop path's 84,000 active observations, 2.7 us at 3.35 TB/s), and does
// 72 flops an observation per CG iteration (~0.27 Gflop for 40, 4 us at
// 67 TFLOP/s). In practice it is latency-bound: each pass is a chain of
// dependent L2 reads (segment start, the observation's keyframe or
// landmark and block, the vector it gathers), and every iteration needs
// two global dot products, so three grid barriers (~1.4 us each).
//
// Design: the observations are sorted once per solve (ObsOrder, the same
// order K4 reduces in): by (landmark, keyframe) and by keyframe, masked
// observations past the last segment, never read. The landmark body is a
// group of LM_LANES (8) lanes a landmark, four landmarks a warp: lane j
// takes the segment's observations j, j + 8, ..., a fixed xor butterfly
// sums the lanes, and lane 0, whose own inputs were read before the
// segment, writes the landmark's row. The keyframe body is a block of 512
// threads a keyframe striding over its segment the same way; a warp
// butterfly and then the 16 warps in order reduce. Every product and sum
// is written out with __fmaf_rn / __fmul_rn / __fadd_rn, so the bodies
// round alike wherever they are inlined. Each observation's block is read
// as 9 float pairs (the wrappers hand the kernels an 8-byte aligned Wpl).
//
// Two entries use the bodies. The passes (schur_lm_pass, schur_kf_pass)
// launch one body each, for S x as a product of its own (a solve sharded
// over devices needs it between all-reduces). The solve (schur_pcg) is one
// cooperative launch of as many 512-thread blocks as are co-resident,
// whose phases walk their items in grid-stride loops with a grid barrier
// between them:
//   setup  per keyframe: r = rhs (y = Hll^-1 bl formed where it is read),
//          z = Minv r, x = 0, and its partial of r.z; and every active
//          observation's block and ids copied into both slot orders, so
//          the iterations read them without the permutations' hop;
//   per CG iteration, three phases:
//   (a)    landmarks with observations: y = Hll^-1 B^T p', with the search
//          direction p = z + beta p_prev formed where it is read;
//   (b)    per keyframe: Ap = kf_opt (Hpp p' - B y), p stored, its partial
//          of p.Ap;
//   (c)    per keyframe, one thread, keyframe k on block k % grid:
//          alpha = r.z / guard(p.Ap), x, r, z = Minv r and its partial of
//          r.z;
//   then the back-substitution, per landmark.
// beta and alpha need the global dot products; every block sums the K
// per-keyframe partials itself in one fixed order (thread t takes partials
// t, t + 512, ..., then the butterflies and the warps in order), so they
// cost no further barrier and every block holds the same bits. No float
// atomics, no per-block partial: the result is bitwise the same at any
// grid size and on every launch, and the solve's S p has the bits of the
// pass launches' S p. Values written in the launch are read with plain
// loads after a grid barrier, never through the non-coherent read-only
// path.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define LM_LANES 8              // lanes a landmark
#define LM_THREADS 256
#define LM_GROUPS (LM_THREADS / LM_LANES)
#define KF_THREADS 512
#define KF_WARPS (KF_THREADS / 32)
#define PCG_THREADS KF_THREADS
#define PCG_WARPS KF_WARPS

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// the sum over an aligned group of LM_LANES lanes, every lane the same bits
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
    for (int off = LM_LANES / 2; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// The 18 floats of an observation's 6 x 3 block (8-byte aligned: 72 B an
// observation from an 8-byte aligned base), through the read-only path
// (a launch input) or the coherent one (written earlier in the launch).
__device__ __forceinline__ void load_block_ro(const float* w, float W[18]) {
    const float2* w2 = (const float2*)w;
#pragma unroll
    for (int q = 0; q < 9; ++q) {
        const float2 v = __ldg(w2 + q);
        W[2 * q] = v.x;
        W[2 * q + 1] = v.y;
    }
}

__device__ __forceinline__ void load_block(const float* w, float W[18]) {
    const float2* w2 = (const float2*)w;
#pragma unroll
    for (int q = 0; q < 9; ++q) {
        const float2 v = w2[q];
        W[2 * q] = v.x;
        W[2 * q + 1] = v.y;
    }
}

// The observations of a landmark's segment slot s: its keyframe (-1 when
// that keyframe is not optimized) and its block. LmObs reads them through
// lm_perm (the pass launches); LmSorted from the slot-ordered copies the
// solve makes once (kfl, Wl).
struct LmObs {
    const int* lm_perm;
    const int* obs_kf;
    const uint8_t* kf_opt;
    const float* Wpl;
    __device__ __forceinline__ int get(int s, float W[18]) const {
        const int o = __ldg(lm_perm + s);
        const int k = __ldg(obs_kf + o);
        load_block_ro(Wpl + 18 * (size_t)o, W);
        return __ldg(kf_opt + k) ? k : -1;
    }
};

struct LmSorted {
    const int* kfl;
    const float* Wl;
    __device__ __forceinline__ int get(int s, float W[18]) const {
        load_block(Wl + 18 * (size_t)s, W);
        return kfl[s];
    }
};

// The observations of a keyframe's segment slot s: its landmark and block.
struct KfObs {
    const int* kf_perm;
    const int* obs_lm;
    const float* Wpl;
    __device__ __forceinline__ int get(int s, float W[18]) const {
        const int o = __ldg(kf_perm + s);
        load_block_ro(Wpl + 18 * (size_t)o, W);
        return __ldg(obs_lm + o);
    }
};

struct KfSorted {
    const int* lmk;
    const float* Wk;
    __device__ __forceinline__ int get(int s, float W[18]) const {
        load_block(Wk + 18 * (size_t)s, W);
        return lmk[s];
    }
};

// a launch input's vector: row i of n floats
template <int N>
struct Vec {
    const float* v;
    __device__ __forceinline__ void row(size_t i, float out[N]) const {
#pragma unroll
        for (int a = 0; a < N; ++a) out[a] = __ldg(v + N * i + a);
    }
};

// a vector written earlier in the launch (8-byte aligned rows)
template <int N>
struct Own {
    const float* v;
    __device__ __forceinline__ void row(size_t i, float out[N]) const {
        if (N % 2 == 0) {
            const float2* v2 = (const float2*)(v + N * i);
#pragma unroll
            for (int a = 0; a < N / 2; ++a) {
                const float2 t = v2[a];
                out[2 * a] = t.x;
                out[2 * a + 1] = t.y;
            }
        } else {
#pragma unroll
            for (int a = 0; a < N; ++a) out[a] = v[N * i + a];
        }
    }
};

// the search direction p = z + beta p_prev (p = z on the first
// iteration), rounded as the plain loop's z + (beta * p_prev)
struct Dir {
    Own<6> z, p;
    float beta;
    int first;
    __device__ __forceinline__ void row(size_t k, float out[6]) const {
        z.row(k, out);
        if (first) return;
        float pp[6];
        p.row(k, pp);
#pragma unroll
        for (int a = 0; a < 6; ++a)
            out[a] = __fadd_rn(out[a], __fmul_rn(beta, pp[a]));
    }
};

// y0 = Hll^-1 bl of landmark l
struct HinvB {
    const float* Hi;
    const float* b;
    __device__ __forceinline__ void row(size_t l, float out[3]) const {
        const float* H = Hi + 9 * l;
        const float b0 = __ldg(b + 3 * l), b1 = __ldg(b + 3 * l + 1),
                    b2 = __ldg(b + 3 * l + 2);
#pragma unroll
        for (int a = 0; a < 3; ++a)
            out[a] = __fmaf_rn(__ldg(H + 3 * a + 2), b2,
                               __fmaf_rn(__ldg(H + 3 * a + 1), b1,
                                         __fmul_rn(__ldg(H + 3 * a), b0)));
    }
};

// Landmark l on a group of LM_LANES lanes (gl its lane), over its segment
// [s0, s1): lane gl takes slots s0 + gl, s0 + gl + LM_LANES, ..., a fixed
// butterfly sums the lanes, and lane 0 writes y_l = lm_opt_l Hll_inv_l (c_l
// - sum_o Wpl_o^T x'[kf_o]) (without c: + the sum). Lane 0's own inputs
// are read before the segment, so their latency hides behind it. Every
// lane of the warp calls it (the butterfly); a group that is not `live`
// passes an empty segment and writes nothing.
template <class O, class X>
__device__ __forceinline__ void lm_body(
    int l, int gl, bool live, int s0, int s1, O obs, X x,
    const uint8_t* __restrict__ lm_opt, const float* __restrict__ Hll_inv,
    const float* __restrict__ c, float* __restrict__ y) {
    float Hi[9], cl[3] = {0.0f, 0.0f, 0.0f}, w = 0.0f;
    if (live && gl == 0) {
#pragma unroll
        for (int q = 0; q < 9; ++q) Hi[q] = __ldg(Hll_inv + 9 * (size_t)l + q);
        if (c)
#pragma unroll
            for (int b = 0; b < 3; ++b) cl[b] = __ldg(c + 3 * (size_t)l + b);
        w = __ldg(lm_opt + l) ? 1.0f : 0.0f;
    }
    float acc[3] = {0.0f, 0.0f, 0.0f};
    for (int s = s0 + gl; s < s1; s += LM_LANES) {
        float W[18], xk[6];
        const int k = obs.get(s, W);
        if (k < 0) continue;
        x.row(k, xk);
#pragma unroll
        for (int b = 0; b < 3; ++b) {
            float v = __fmul_rn(W[b], xk[0]);
#pragma unroll
            for (int a = 1; a < 6; ++a) v = __fmaf_rn(W[3 * a + b], xk[a], v);
            acc[b] = __fadd_rn(acc[b], v);
        }
    }
#pragma unroll
    for (int b = 0; b < 3; ++b) acc[b] = group_sum(acc[b]);
    if (!live || gl != 0) return;
    float v[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) v[b] = c ? __fsub_rn(cl[b], acc[b]) : acc[b];
#pragma unroll
    for (int a = 0; a < 3; ++a)
        y[3 * (size_t)l + a] = __fmul_rn(
            __fmaf_rn(Hi[3 * a + 2], v[2],
                      __fmaf_rn(Hi[3 * a + 1], v[1],
                                __fmul_rn(Hi[3 * a], v[0]))),
            w);
}

// Keyframe k on a block of KF_THREADS threads (red: [KF_WARPS][6] shared
// sums): out_k = kf_opt_k (a_k - sum_o Wpl_o y[lm_o]) with a_k = Hpp_k
// (kf_opt_k x_k) when Hpp is given, else a_in's row. Threads tid < 6
// return entry tid, the others 0. Every thread of the block calls it (it
// holds two __syncthreads).
template <class O, class Y, class X>
__device__ __forceinline__ float kf_body(
    int k, int tid, float (*red)[6], int s0, int s1, O obs, Y y,
    const uint8_t* __restrict__ kf_opt, const float* __restrict__ Hpp, X x,
    const float* __restrict__ a_in) {
    const int lane = tid & 31, wq = tid >> 5;
    float base = 0.0f, ko = 0.0f;
    if (tid < 6) {
        ko = __ldg(kf_opt + k) ? 1.0f : 0.0f;
        if (Hpp) {
            float xk[6];
            x.row(k, xk);
            const float* H = Hpp + 36 * (size_t)k + 6 * tid;
            base = __fmul_rn(__ldg(H), __fmul_rn(xk[0], ko));
#pragma unroll
            for (int b = 1; b < 6; ++b)
                base = __fmaf_rn(__ldg(H + b), __fmul_rn(xk[b], ko), base);
        } else {
            base = __ldg(a_in + 6 * (size_t)k + tid);
        }
    }
    float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int s = s0 + tid; s < s1; s += KF_THREADS) {
        float W[18], yl[3];
        y.row(obs.get(s, W), yl);
#pragma unroll
        for (int a = 0; a < 6; ++a)
            acc[a] = __fadd_rn(
                acc[a], __fmaf_rn(W[3 * a + 2], yl[2],
                                  __fmaf_rn(W[3 * a + 1], yl[1],
                                            __fmul_rn(W[3 * a], yl[0]))));
    }
    __syncthreads();            // the previous keyframe's reads of red
#pragma unroll
    for (int a = 0; a < 6; ++a) {
        const float v = warp_sum(acc[a]);
        if (lane == 0) red[wq][a] = v;
    }
    __syncthreads();
    if (tid >= 6) return 0.0f;
    float by = red[0][tid];
#pragma unroll
    for (int q = 1; q < KF_WARPS; ++q) by = __fadd_rn(by, red[q][tid]);
    return __fmul_rn(__fsub_rn(base, by), ko);
}

__device__ __forceinline__ float guard(float v) {
    return fabsf(v) < 1e-20f ? 1e-20f : v;
}

// sum of part[0, K) in one fixed order, the same bits in every block at
// any grid: thread t sums t, t + KF_THREADS, ..., each warp's butterfly
// (pairs commute exactly), then the warps in order; every thread of the
// block calls it, the result in all of them (sh: KF_WARPS + 1 floats)
__device__ __forceinline__ float block_sum(const float* part, int K,
                                           int tid, float* sh) {
    float s = 0.0f;
    for (int k = tid; k < K; k += KF_THREADS) s = __fadd_rn(s, part[k]);
    s = warp_sum(s);
    if ((tid & 31) == 0) sh[tid >> 5] = s;
    __syncthreads();
    if (tid == 0) {
        float t = sh[0];
        for (int q = 1; q < KF_WARPS; ++q) t = __fadd_rn(t, sh[q]);
        sh[KF_WARPS] = t;
    }
    __syncthreads();
    const float t = sh[KF_WARPS];
    __syncthreads();            // sh is free again
    return t;
}

// z = kf_opt Minv_k r; returns r.z
__device__ __forceinline__ float precond(const float* __restrict__ Minv,
                                         int k, const float r[6], float ko,
                                         float z[6]) {
    const float* M = Minv + 36 * (size_t)k;
    float rz = 0.0f;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
        float v = __fmul_rn(__ldg(M + 6 * a), r[0]);
#pragma unroll
        for (int b = 1; b < 6; ++b)
            v = __fmaf_rn(__ldg(M + 6 * a + b), r[b], v);
        z[a] = __fmul_rn(v, ko);
        rz = a ? __fmaf_rn(r[a], z[a], rz) : __fmul_rn(r[0], z[0]);
    }
    return rz;
}

__global__ void __launch_bounds__(LM_THREADS)
schur_lm_kernel(const float* __restrict__ Wpl, const float* __restrict__ x,
                const uint8_t* __restrict__ kf_opt,
                const uint8_t* __restrict__ lm_opt,
                const float* __restrict__ Hll_inv,
                const float* __restrict__ c,
                const int* __restrict__ obs_kf,
                const int* __restrict__ lm_perm,
                const int* __restrict__ lm_start, int L,
                float* __restrict__ y) {
    const int l = blockIdx.x * LM_GROUPS + threadIdx.x / LM_LANES;
    const bool live = l < L;
    lm_body(l, threadIdx.x % LM_LANES, live, live ? __ldg(lm_start + l) : 0,
            live ? __ldg(lm_start + l + 1) : 0,
            LmObs{lm_perm, obs_kf, kf_opt, Wpl}, Vec<6>{x}, lm_opt, Hll_inv,
            c, y);
}

__global__ void __launch_bounds__(KF_THREADS)
schur_kf_kernel(const float* __restrict__ Wpl, const float* __restrict__ y,
                const uint8_t* __restrict__ kf_opt,
                const float* __restrict__ Hpp, const float* __restrict__ x,
                const float* __restrict__ a_in,
                const int* __restrict__ obs_lm,
                const int* __restrict__ kf_perm,
                const int* __restrict__ kf_start, float* __restrict__ out) {
    __shared__ float red[KF_WARPS][6];
    const int k = blockIdx.x, tid = threadIdx.x;
    const float v = kf_body(k, tid, red, __ldg(kf_start + k),
                            __ldg(kf_start + k + 1),
                            KfObs{kf_perm, obs_lm, Wpl}, Vec<3>{y}, kf_opt,
                            Hpp, Vec<6>{x}, a_in);
    if (tid < 6) out[6 * (size_t)k + tid] = v;
}

struct PcgArgs {
    const float *Wpl, *Hpp, *Minv, *Hll_inv, *bp, *bl;
    const uint8_t *kf_opt, *lm_opt;
    const int *obs_kf, *obs_lm, *kf_perm, *kf_start, *lm_perm, *lm_start;
    int K, L, iters;
    // scratch: p, z, r, Ap (K, 6); the partials of p.Ap and r.z (K); y
    // (L, 3); the blocks and ids in slot order: Wl, Wk (O, 18); kfl, lmk
    // (O,)
    float *p, *z, *r, *Ap, *pap, *rzp, *y, *Wl, *Wk;
    int *kfl, *lmk;
    // out: dxp (K, 6), which holds x during the solve; dxl (L, 3)
    float *dxp, *dxl;
};

__global__ void __launch_bounds__(PCG_THREADS, 2)
schur_pcg_kernel(PcgArgs A) {
    __shared__ float red[KF_WARPS][6];
    __shared__ float res[6], pk[6];    // a keyframe's out and its p
    __shared__ float sh[KF_WARPS + 1];
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    const int tid = threadIdx.x;
    const int K = A.K, L = A.L;
    // landmarks: LM_LANES lanes each, 32 / LM_LANES a warp, the warps of
    // the grid striding together
    const int gl = tid % LM_LANES, lg = (tid % 32) / LM_LANES;
    const int lw = blockIdx.x * PCG_WARPS + tid / 32;
    const int lstride = gridDim.x * PCG_WARPS * (32 / LM_LANES);
    const KfObs kf_obs{A.kf_perm, A.obs_lm, A.Wpl};
    const LmSorted lm_sorted{A.kfl, A.Wl};
    const KfSorted kf_sorted{A.lmk, A.Wk};

    // setup: r = rhs = kf_opt (bp - B Hll^-1 bl), z = Minv r, x = 0
    for (int k = blockIdx.x; k < K; k += gridDim.x) {
        const float v = kf_body(k, tid, red, __ldg(A.kf_start + k),
                                __ldg(A.kf_start + k + 1), kf_obs,
                                HinvB{A.Hll_inv, A.bl}, A.kf_opt, nullptr,
                                Vec<6>{nullptr}, A.bp);
        if (tid < 6) res[tid] = v;
        __syncthreads();
        if (tid == 0) {
            const float ko = __ldg(A.kf_opt + k) ? 1.0f : 0.0f;
            float z[6];
            const float rz = precond(A.Minv, k, res, ko, z);
            for (int a = 0; a < 6; ++a) {
                A.r[6 * (size_t)k + a] = res[a];
                A.z[6 * (size_t)k + a] = z[a];
                A.dxp[6 * (size_t)k + a] = 0.0f;
            }
            A.rzp[k] = rz;
        }
    }
    // and the observations' blocks and ids in both slot orders
    const int n_lm = __ldg(A.lm_start + L), n_kf = __ldg(A.kf_start + K);
    for (int s = blockIdx.x * PCG_THREADS + tid; s < max(n_lm, n_kf);
         s += gridDim.x * PCG_THREADS) {
        float W[18];
        if (s < n_lm) {
            A.kfl[s] = LmObs{A.lm_perm, A.obs_kf, A.kf_opt, A.Wpl}.get(s, W);
            float2* d = (float2*)(A.Wl + 18 * (size_t)s);
            for (int q = 0; q < 9; ++q) d[q] = make_float2(W[2 * q],
                                                           W[2 * q + 1]);
        }
        if (s < n_kf) {
            A.lmk[s] = kf_obs.get(s, W);
            float2* d = (float2*)(A.Wk + 18 * (size_t)s);
            for (int q = 0; q < 9; ++q) d[q] = make_float2(W[2 * q],
                                                           W[2 * q + 1]);
        }
    }
    grid.sync();

    float rz = 0.0f;
    for (int it = 0; it < A.iters; ++it) {
        // rz_i from the partials; beta = rz_i / guard(rz_{i-1})
        const float rz_new = block_sum(A.rzp, K, tid, sh);
        const Dir dir{Own<6>{A.z}, Own<6>{A.p},
                      it ? rz_new / guard(rz) : 0.0f, it == 0};
        rz = rz_new;

        // (a) y = lm_opt Hll^-1 B^T p' over the landmarks with
        // observations (y_l of the others is never read)
        for (int l0 = lw * (32 / LM_LANES); l0 < L; l0 += lstride) {
            const int l = l0 + lg;
            const int s0 = l < L ? __ldg(A.lm_start + l) : 0;
            const int s1 = l < L ? __ldg(A.lm_start + l + 1) : 0;
            if (__all_sync(0xffffffffu, s0 == s1)) continue;
            lm_body(l, gl, s0 != s1, s0, s1, lm_sorted, dir, A.lm_opt,
                    A.Hll_inv, nullptr, A.y);
        }
        grid.sync();

        // (b) Ap = kf_opt (Hpp p' - B y); p stored; p.Ap partials
        for (int k = blockIdx.x; k < K; k += gridDim.x) {
            const float v = kf_body(k, tid, red, __ldg(A.kf_start + k),
                                    __ldg(A.kf_start + k + 1), kf_sorted,
                                    Own<3>{A.y}, A.kf_opt, A.Hpp, dir,
                                    nullptr);
            if (tid == 0) {     // kf_body's barriers keep the last
                float pv[6];    // keyframe's readers of pk first
                dir.row(k, pv);
                for (int a = 0; a < 6; ++a) pk[a] = pv[a];
            }
            if (tid < 6) res[tid] = v;
            __syncthreads();            // every read of p_prev[k] is done
            if (tid < 6) {
                A.Ap[6 * (size_t)k + tid] = res[tid];
                A.p[6 * (size_t)k + tid] = pk[tid];
            }
            if (tid == 0) {
                float s = __fmul_rn(pk[0], res[0]);
                for (int a = 1; a < 6; ++a) s = __fmaf_rn(pk[a], res[a], s);
                A.pap[k] = s;
            }
        }
        grid.sync();

        // (c) alpha = rz / guard(p.Ap); x += alpha p; r -= alpha Ap;
        // z = kf_opt Minv r; r.z partials (on the last iteration x alone,
        // written as dxp = kf_opt x). Keyframe k on block k % grid, so no
        // SM reads many keyframes' Minv.
        const bool last = it + 1 == A.iters;
        if (blockIdx.x < K) {
            const float alpha = rz / guard(block_sum(A.pap, K, tid, sh));
            for (int k = blockIdx.x + gridDim.x * tid; k < K;
                 k += gridDim.x * PCG_THREADS) {
                const float ko = __ldg(A.kf_opt + k) ? 1.0f : 0.0f;
                float x[6], pk[6], ap[6], r[6], z[6];
                Own<6>{A.dxp}.row(k, x);
                Own<6>{A.p}.row(k, pk);
                Own<6>{A.Ap}.row(k, ap);
                Own<6>{A.r}.row(k, r);
                for (int a = 0; a < 6; ++a) {
                    const float xa = __fadd_rn(x[a], __fmul_rn(alpha, pk[a]));
                    A.dxp[6 * (size_t)k + a] = last ? __fmul_rn(xa, ko) : xa;
                    r[a] = __fsub_rn(r[a], __fmul_rn(alpha, ap[a]));
                }
                if (last) continue;
                const float rzk = precond(A.Minv, k, r, ko, z);
                for (int a = 0; a < 6; ++a) {
                    A.r[6 * (size_t)k + a] = r[a];
                    A.z[6 * (size_t)k + a] = z[a];
                }
                A.rzp[k] = rzk;
            }
        }
        grid.sync();
    }

    // back-substitution: dxl = lm_opt Hll^-1 (bl - B^T dxp), every landmark
    for (int l0 = lw * (32 / LM_LANES); l0 < L; l0 += lstride) {
        const int l = l0 + lg;
        const bool live = l < L;
        lm_body(l, gl, live, live ? __ldg(A.lm_start + l) : 0,
                live ? __ldg(A.lm_start + l + 1) : 0, lm_sorted,
                Own<6>{A.dxp}, A.lm_opt, A.Hll_inv, A.bl, A.dxl);
    }
}

extern "C" int schur_lm_pass(const void* Wpl, const void* x,
                             const void* kf_opt, const void* lm_opt,
                             const void* Hll_inv, const void* c,
                             const void* obs_kf, const void* lm_perm,
                             const void* lm_start, int L, void* y,
                             void* stream) {
    if (L == 0) return 0;
    if ((uintptr_t)Wpl % 8) return (int)cudaErrorMisalignedAddress;
    const int blocks = (L + LM_GROUPS - 1) / LM_GROUPS;
    schur_lm_kernel<<<blocks, LM_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)Wpl, (const float*)x, (const uint8_t*)kf_opt,
        (const uint8_t*)lm_opt, (const float*)Hll_inv, (const float*)c,
        (const int*)obs_kf, (const int*)lm_perm, (const int*)lm_start, L,
        (float*)y);
    return (int)cudaGetLastError();
}

extern "C" int schur_kf_pass(const void* Wpl, const void* y,
                             const void* kf_opt, const void* Hpp,
                             const void* x, const void* a,
                             const void* obs_lm, const void* kf_perm,
                             const void* kf_start, int K, void* out,
                             void* stream) {
    if (K == 0) return 0;
    if ((uintptr_t)Wpl % 8) return (int)cudaErrorMisalignedAddress;
    schur_kf_kernel<<<K, KF_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)Wpl, (const float*)y, (const uint8_t*)kf_opt,
        (const float*)Hpp, (const float*)x, (const float*)a,
        (const int*)obs_lm, (const int*)kf_perm, (const int*)kf_start,
        (float*)out);
    return (int)cudaGetLastError();
}

// The blocks of schur_pcg_kernel that are co-resident on the current card.
extern "C" int schur_pcg_max_grid(int* grid) {
    static int max_grid[64];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (max_grid[dev] == 0) {
        int per_sm = 0, sms = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, schur_pcg_kernel, PCG_THREADS, 0);
        if (e != cudaSuccess) return (int)e;
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return (int)e;
        max_grid[dev] = per_sm * sms;
    }
    *grid = max_grid[dev];
    return *grid > 0 ? 0 : (int)cudaErrorCooperativeLaunchTooLarge;
}

// The whole PCG solve of one LM step in one cooperative launch of `grid`
// blocks (0: the co-resident maximum). scratch: 26 K + 3 L floats;
// wscratch: 36 O floats (8-byte aligned); iscratch: 2 O ints, O the
// observation slots.
extern "C" int schur_pcg(const void* Wpl, const void* Hpp, const void* Minv,
                         const void* Hll_inv, const void* bp, const void* bl,
                         const void* kf_opt, const void* lm_opt,
                         const void* obs_kf, const void* obs_lm,
                         const void* kf_perm, const void* kf_start,
                         const void* lm_perm, const void* lm_start, int K,
                         int L, int O, int iters, int grid, void* scratch,
                         void* wscratch, void* iscratch, void* dxp,
                         void* dxl, void* stream) {
    if (K == 0 && L == 0) return 0;
    if ((uintptr_t)Wpl % 8 || (uintptr_t)scratch % 8 ||
        (uintptr_t)wscratch % 8 || (uintptr_t)dxp % 8)
        return (int)cudaErrorMisalignedAddress;
    int max_grid = 0;
    const int rc = schur_pcg_max_grid(&max_grid);
    if (rc) return rc;
    if (grid == 0) grid = max_grid;
    if (grid < 1 || grid > max_grid || iters < 0)
        return (int)cudaErrorInvalidValue;
    float* s = (float*)scratch;
    PcgArgs A;
    A.Wpl = (const float*)Wpl;
    A.Hpp = (const float*)Hpp;
    A.Minv = (const float*)Minv;
    A.Hll_inv = (const float*)Hll_inv;
    A.bp = (const float*)bp;
    A.bl = (const float*)bl;
    A.kf_opt = (const uint8_t*)kf_opt;
    A.lm_opt = (const uint8_t*)lm_opt;
    A.obs_kf = (const int*)obs_kf;
    A.obs_lm = (const int*)obs_lm;
    A.kf_perm = (const int*)kf_perm;
    A.kf_start = (const int*)kf_start;
    A.lm_perm = (const int*)lm_perm;
    A.lm_start = (const int*)lm_start;
    A.K = K;
    A.L = L;
    A.iters = iters;
    A.p = s;
    A.z = A.p + 6 * (size_t)K;
    A.r = A.z + 6 * (size_t)K;
    A.Ap = A.r + 6 * (size_t)K;
    A.pap = A.Ap + 6 * (size_t)K;
    A.rzp = A.pap + K;
    A.y = A.rzp + K;
    A.Wl = (float*)wscratch;
    A.Wk = A.Wl + 18 * (size_t)O;
    A.kfl = (int*)iscratch;
    A.lmk = A.kfl + O;
    A.dxp = (float*)dxp;
    A.dxl = (float*)dxl;
    void* args[] = {(void*)&A};
    return (int)cudaLaunchCooperativeKernel((const void*)schur_pcg_kernel,
                                            dim3(grid), dim3(PCG_THREADS),
                                            args, 0, (cudaStream_t)stream);
}
