// K14: the implicit Schur product of the global BA's preconditioned CG
// solve, as two passes over the observations, with the coupling held per
// observation (Wpl (O, 6, 3), K4's per-observation mode):
//
//   landmark pass  y_l   = lm_opt_l Hll_inv_l (c_l - sum_o Wpl_o^T x'[kf_o])
//   keyframe pass  out_k = kf_opt_k (a_k - sum_o Wpl_o y[lm_o])
//
// with x' = kf_opt x, and a_k = Hpp_k x'_k or a given vector; without c
// the landmark pass gives + sum_o Wpl_o^T x'[kf_o]. S x is the landmark
// pass (no c) then the keyframe pass
// (a = Hpp x'); the right-hand side bp - B Hll^-1 bl is the keyframe pass
// alone (a = bp, y = Hll^-1 bl); the back-substitution
// Hll^-1 (bl - B^T dxp) is the landmark pass with c = bl.
//
// Replaces S_matvec of morb_slam_tpu/optim/ba.py:ba_solve_pcg (two gather +
// segment_sum passes per CG iteration, 40 iterations per LM step) and its
// two half-passes for the right-hand side and the back-substitution. The
// plain versions (gathers + index_add_) are in optim/ba.py.
//
// What bounds it on an H100: bytes. Each pass reads every active
// observation's 72-byte block and two indices (~80 B per observation),
// against 36 flops per observation; the vectors it gathers (24 B per
// keyframe, 12 B per landmark) sit in L2.
//
// Design: the observations are sorted once per solve (ObsOrder, the same
// order K4 reduces in): by (landmark, keyframe) and by keyframe, masked
// observations past the last segment, never read. Landmark pass: one warp
// per landmark; lane j takes the segment's observations j, j + 32, ...,
// sums them, and a fixed xor butterfly reduces the lanes. Keyframe pass: one
// block of 128 threads per keyframe strides over its segment the same way;
// a warp butterfly and then the 4 warps in order reduce. No float atomics:
// two launches on the same input give the same bits. Making it fast (the
// whole CG loop in one persistent launch, Wpl staged in shared memory) is
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

#define LM_THREADS 256
#define LM_WARPS (LM_THREADS / 32)
#define KF_THREADS 128
#define KF_WARPS (KF_THREADS / 32)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
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
    const int lane = threadIdx.x & 31;
    const int l = blockIdx.x * LM_WARPS + (threadIdx.x >> 5);
    if (l >= L) return;
    float acc[3] = {0.0f, 0.0f, 0.0f};
    for (int s = lm_start[l] + lane; s < lm_start[l + 1]; s += 32) {
        const int o = lm_perm[s];
        const int k = obs_kf[o];
        if (!kf_opt[k]) continue;
        const float* W = Wpl + 18 * (size_t)o;
        const float* xk = x + 6 * (size_t)k;
#pragma unroll
        for (int b = 0; b < 3; ++b) {
            float v = 0.0f;
#pragma unroll
            for (int a = 0; a < 6; ++a) v += W[3 * a + b] * xk[a];
            acc[b] += v;
        }
    }
#pragma unroll
    for (int b = 0; b < 3; ++b) acc[b] = warp_sum(acc[b]);
    if (lane != 0) return;
    float v[3];
#pragma unroll
    for (int b = 0; b < 3; ++b)
        v[b] = c ? c[3 * (size_t)l + b] - acc[b] : acc[b];
    const float* Hi = Hll_inv + 9 * (size_t)l;
    const float w = lm_opt[l] ? 1.0f : 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a)
        y[3 * (size_t)l + a] =
            (Hi[3 * a] * v[0] + Hi[3 * a + 1] * v[1] + Hi[3 * a + 2] * v[2]) *
            w;
}

__global__ void __launch_bounds__(KF_THREADS)
schur_kf_kernel(const float* __restrict__ Wpl, const float* __restrict__ y,
                const uint8_t* __restrict__ kf_opt,
                const float* __restrict__ Hpp, const float* __restrict__ x,
                const float* __restrict__ a_in,
                const int* __restrict__ obs_lm,
                const int* __restrict__ kf_perm,
                const int* __restrict__ kf_start, int K,
                float* __restrict__ out) {
    __shared__ float red[KF_WARPS][6];
    const int k = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int s = kf_start[k] + tid; s < kf_start[k + 1]; s += KF_THREADS) {
        const int o = kf_perm[s];
        const float* W = Wpl + 18 * (size_t)o;
        const float* yl = y + 3 * (size_t)obs_lm[o];
        const float y0 = yl[0], y1 = yl[1], y2 = yl[2];
#pragma unroll
        for (int a = 0; a < 6; ++a)
            acc[a] += W[3 * a] * y0 + W[3 * a + 1] * y1 + W[3 * a + 2] * y2;
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) {
        const float v = warp_sum(acc[a]);
        if (lane == 0) red[warp][a] = v;
    }
    __syncthreads();
    if (tid >= 6) return;
    float by = 0.0f;
    for (int wq = 0; wq < KF_WARPS; ++wq) by += red[wq][tid];
    const float ko = kf_opt[k] ? 1.0f : 0.0f;
    float base;
    if (Hpp) {
        const float* H = Hpp + 36 * (size_t)k + 6 * tid;
        const float* xk = x + 6 * (size_t)k;
        base = 0.0f;
        for (int b = 0; b < 6; ++b) base += H[b] * (xk[b] * ko);
    } else {
        base = a_in[6 * (size_t)k + tid];
    }
    out[6 * (size_t)k + tid] = (base - by) * ko;
}

extern "C" int schur_lm_pass(const void* Wpl, const void* x,
                             const void* kf_opt, const void* lm_opt,
                             const void* Hll_inv, const void* c,
                             const void* obs_kf, const void* lm_perm,
                             const void* lm_start, int L, void* y,
                             void* stream) {
    if (L == 0) return 0;
    const int blocks = (L + LM_WARPS - 1) / LM_WARPS;
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
    schur_kf_kernel<<<K, KF_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)Wpl, (const float*)y, (const uint8_t*)kf_opt,
        (const float*)Hpp, (const float*)x, (const float*)a,
        (const int*)obs_lm, (const int*)kf_perm, (const int*)kf_start, K,
        (float*)out);
    return (int)cudaGetLastError();
}
