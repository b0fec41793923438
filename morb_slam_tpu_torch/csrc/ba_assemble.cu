// K4: the bundle adjustment's observation assembly at one state, in one
// launch: every observation's residual, Jacobians and Huber weight, and
// their block sums Hpp (K, 6, 6), bp (K, 6), the dense coupling
// Bt (L, K, 6, 3), Hll (L, 3, 3), bl (L, 3), with the robust cost. In its
// per-observation mode (`per_obs` = 1, the global BA's PCG solve) it
// writes the coupling per observation instead, Wpl (O, 6, 3) = Jp^T w Jl
// in observation order, unweighted by lm_opt and zero for masked
// observations (the reference's optim/ba.py:_assemble_blocks), and no
// dense Bt exists.
//
// Replaces the assembly of morb_slam_tpu/optim/ba.py:ba_solve (terms_of and
// the block sums of lm_step) and the visual blocks of
// morb_slam_tpu/optim/vi_ba.py:_lm_step / _total_cost (_visual_terms), which
// differ only in the pose Jacobian: camera tangent [I | -hat(Xc)] against
// body tangent [-I | hat(Xc)] (`body` = 1). Every keyframe insert runs one
// local BA (5 or 6 LM iterations, one launch per state).
//
// What bounds it on an H100: bytes. It reads ~33 B per active observation
// and writes the coupling: the dense one, 72 B per (landmark, keyframe)
// pair (8 MB at 6,144 landmarks x 18 keyframes), or 72 B per observation
// slot, masked ones included (44 MB at 614,400 slots), against ~400 flops
// per active observation.
//
// Design: observations are sorted once per solve (by the wrapper, on the
// card) by keyframe and by (landmark, keyframe); every sum then runs over a
// segment in that fixed order, starting from zero, without float atomics,
// so two launches on the same input give the same bits. Three kinds of
// 256-thread blocks share the launch:
//  - Keyframe blocks [0, K) each own one keyframe: the threads stride over
//    its observations and accumulate the 21 upper entries of Hpp, the 6 of
//    Jp^T w r and the cost; a fixed-order warp butterfly and a pass over
//    the 8 warps reduce them. The keyframes' partial costs land in scratch;
//    the last keyframe block to finish (an integer ticket) sums them in
//    keyframe order.
//  - Landmark blocks, LM_PER_BLOCK landmarks each: in local mode the block
//    first zeroes its landmarks' rows of Bt with 16-byte stores (one
//    contiguous stretch). Then, 256 observations of the block's segment of
//    the (landmark, keyframe) order at a time, every thread forms one
//    observation's coupling block, Hll and bl terms into shared memory,
//    and a thread a landmark adds its observations' values in that order:
//    a landmark seen by many keyframes costs as many additions, not as
//    many chains of dependent loads. Each (landmark, keyframe) pair's
//    coupling block is summed in registers and stored once (8-byte
//    stores). No value is read back from global memory.
//  - Per-observation mode only, slot blocks: a thread an observation slot
//    in observation order. An active slot's block Jp^T w Jl is formed in
//    registers; the warp stages its 32 slots' blocks (2,304 contiguous
//    bytes) in shared memory and writes them, masked slots as zeros, with
//    16-byte stores; a warp of masked slots writes its zeros at once. So
//    the wrapper allocates Wpl uninitialized and runs no fill.
// Masked observations sort past every segment and add nothing; the plain
// version adds them with weight 0. Each sum adds its terms in the order of
// the earlier one-lane-a-landmark form, so the outputs keep its bits.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define NWARPS (THREADS / 32)
#define NACC 28  // 21 Hpp + 6 g + cost
// landmarks a landmark block takes (at most THREADS); the whole block
// zeroes their rows of Bt first
#define LM_PER_BLOCK 32
// values an observation hands to its landmark's thread: the coupling
// block (18), its Hll (9) and bl (3) terms
#define NV 30

#define HUBER2_MONO 5.991f
#define HUBER2_STEREO 7.815f

struct Terms {
    float r[3];
    float Jp[3][6];
    float Jl[3][3];
    float w;
    bool stereo;
};

// optim/ba.py:_obs_terms for observation o (robust weights). Every product
// and sum is rounded where the compiler rounded it in the earlier
// one-lane-a-landmark form of this kernel (its keyframe and landmark
// passes agreed), written out with the _rn intrinsics, which no compiler
// fuses or splits: so each kind of block, wherever it inlines this, gets
// the same bits as that form. The zeros of J_pt stay as products (0 * z is
// -0 for z < 0).
__device__ __forceinline__ void obs_terms(
    int o, const float* R, const float* t, const float* X,
    const int* obs_kf, const int* obs_lm, const float* obs_uv,
    const float* obs_ur, const float* obs_info, const uint8_t* obs_mask,
    float baseline, float sign, Terms& T) {
    const int k = obs_kf[o], l = obs_lm[o];
    const float* Rk = R + 9 * (size_t)k;
    const float* tk = t + 3 * (size_t)k;
    const float X0 = X[3 * (size_t)l], X1 = X[3 * (size_t)l + 1],
                X2 = X[3 * (size_t)l + 2];
    float Xc[3];
    for (int i = 0; i < 3; ++i)
        Xc[i] = __fadd_rn(
            __fmaf_rn(Rk[3 * i + 2], X2,
                      __fmaf_rn(Rk[3 * i], X0, __fmul_rn(Rk[3 * i + 1], X1))),
            tk[i]);
    const float x = Xc[0], y = Xc[1], z = Xc[2];
    const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;
    const float iz = 1.0f / zs, iz2 = __fmul_rn(iz, iz);
    const float ur = obs_ur[o];
    T.stereo = isfinite(ur);
    const float xiz = __fmul_rn(x, iz), yiz = __fmul_rn(y, iz);
    const float xb = __fsub_rn(x, baseline);
    T.r[0] = __fsub_rn(xiz, obs_uv[2 * (size_t)o]);
    T.r[1] = __fsub_rn(yiz, obs_uv[2 * (size_t)o + 1]);
    T.r[2] = T.stereo ? __fmaf_rn(iz, xb, -ur) : 0.0f;
    // J_pt rows (a, b, c): (iz, 0, -x iz2), (0, iz, -y iz2), and the
    // stereo row (iz, 0, -(x - baseline) iz2) or zeros
    const float xiz2 = __fmul_rn(x, iz2), yiz2 = __fmul_rn(y, iz2);
    const float a2 = T.stereo ? iz : 0.0f;
    const float c2 = T.stereo ? -__fmul_rn(xb, iz2) : 0.0f;
    const float x0 = __fmul_rn(0.0f, x), z0 = __fmul_rn(0.0f, z);
    const float ziz = __fmul_rn(z, iz), zero = __fmul_rn(0.0f, sign);
    // J_pt [I | -hat(Xc)], negated for the body tangent
    T.Jp[0][0] = __fmul_rn(sign, iz);
    T.Jp[0][1] = zero;
    T.Jp[0][2] = __fmul_rn(sign, -xiz2);
    T.Jp[0][3] = __fmul_rn(sign, __fmaf_rn(y, -xiz2, -z0));
    T.Jp[0][4] = __fmul_rn(sign, __fmaf_rn(x, xiz2, ziz));
    T.Jp[0][5] = __fmul_rn(sign, __fsub_rn(x0, yiz));
    T.Jp[1][0] = zero;
    T.Jp[1][1] = T.Jp[0][0];
    T.Jp[1][2] = __fmul_rn(sign, -yiz2);
    T.Jp[1][3] = __fmul_rn(sign, __fmaf_rn(y, -yiz2, -ziz));
    T.Jp[1][4] = __fmul_rn(sign, __fmaf_rn(x, yiz2, z0));
    T.Jp[1][5] = __fmul_rn(sign, __fmaf_rn(-0.0f, y, xiz));
    T.Jp[2][0] = __fmul_rn(sign, a2);
    T.Jp[2][1] = zero;
    T.Jp[2][2] = __fmul_rn(sign, c2);
    T.Jp[2][3] = __fmul_rn(sign, __fmaf_rn(y, c2, -z0));
    T.Jp[2][4] = __fmul_rn(sign, __fmaf_rn(z, a2, -__fmul_rn(x, c2)));
    T.Jp[2][5] = __fmul_rn(sign, __fmaf_rn(-y, a2, x0));
    // J_pt R_k: a R[0, j] + b R[1, j] + c R[2, j]
    for (int j = 0; j < 3; ++j) {
        T.Jl[0][j] = __fmaf_rn(-xiz2, Rk[6 + j],
                               __fmaf_rn(iz, Rk[j], __fmul_rn(0.0f, Rk[3 + j])));
        T.Jl[1][j] = __fmaf_rn(-yiz2, Rk[6 + j],
                               __fmaf_rn(0.0f, Rk[j], __fmul_rn(iz, Rk[3 + j])));
        T.Jl[2][j] = __fmaf_rn(c2, Rk[6 + j],
                               __fmaf_rn(a2, Rk[j], __fmul_rn(0.0f, Rk[3 + j])));
    }
    const float info = obs_info[o];
    const float chi2 = __fmul_rn(
        __fmaf_rn(T.r[2], T.r[2],
                  __fmaf_rn(T.r[0], T.r[0], __fmul_rn(T.r[1], T.r[1]))),
        info);
    const float d2 = T.stereo ? HUBER2_STEREO : HUBER2_MONO;
    const float hub = chi2 <= d2 ? 1.0f : sqrtf(d2 / fmaxf(chi2, 1e-12f));
    T.w = (obs_mask[o] && z > 0.0f) ? __fmul_rn(info, hub) : 0.0f;
}

// one observation's coupling block Jp^T wb Jl (18 floats, row-major 6 x 3)
__device__ __forceinline__ void coupling(const Terms& T, float wb,
                                         float* v) {
    for (int a = 0; a < 6; ++a) {
        const float p0 = __fmul_rn(T.Jp[0][a], wb),
                    p1 = __fmul_rn(T.Jp[1][a], wb),
                    p2 = __fmul_rn(T.Jp[2][a], wb);
        for (int b = 0; b < 3; ++b)
            v[3 * a + b] = __fmaf_rn(
                p2, T.Jl[2][b],
                __fmaf_rn(p1, T.Jl[1][b], __fmaf_rn(p0, T.Jl[0][b], 0.0f)));
    }
}

// one observation's Hll terms Jl^T w Jl (9) and bl terms Jl^T w r (3)
__device__ __forceinline__ void landmark_parts(const Terms& T, float* vh,
                                               float* vg) {
    for (int a = 0; a < 3; ++a) {
        const float p0 = __fmul_rn(T.Jl[0][a], T.w),
                    p1 = __fmul_rn(T.Jl[1][a], T.w),
                    p2 = __fmul_rn(T.Jl[2][a], T.w);
        for (int b = 0; b < 3; ++b)
            vh[3 * a + b] = __fmaf_rn(
                p2, T.Jl[2][b],
                __fmaf_rn(p1, T.Jl[1][b], __fmaf_rn(p0, T.Jl[0][b], 0.0f)));
        vg[a] = __fmaf_rn(p2, T.r[2],
                          __fmaf_rn(p1, T.r[1], __fmaf_rn(p0, T.r[0], 0.0f)));
    }
}

// 18 floats at an 8-byte aligned address
__device__ __forceinline__ void store18(float* dst, const float* v) {
    float2* d = reinterpret_cast<float2*>(dst);
#pragma unroll
    for (int q = 0; q < 9; ++q) d[q] = make_float2(v[2 * q], v[2 * q + 1]);
}

// zero n floats (n even) from a 16-byte aligned address, `lanes` threads
__device__ __forceinline__ void zero_n(float* dst, size_t n, int i,
                                       int lanes) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    const size_t n4 = n / 4;
    for (size_t q = i; q < n4; q += lanes)
        d4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i == 0 && (n & 3))
        reinterpret_cast<float2*>(dst)[n / 2 - 1] = make_float2(0.f, 0.f);
}

__device__ __forceinline__ void zero_block(float* dst, size_t n, int tid) {
    zero_n(dst, n, tid, THREADS);
}

__global__ void __launch_bounds__(THREADS)
ba_assemble_kernel(const float* __restrict__ R, const float* __restrict__ t,
                   const float* __restrict__ X,
                   const int* __restrict__ obs_kf,
                   const int* __restrict__ obs_lm,
                   const float* __restrict__ obs_uv,
                   const float* __restrict__ obs_ur,
                   const float* __restrict__ obs_info,
                   const uint8_t* __restrict__ obs_mask,
                   const uint8_t* __restrict__ lm_opt,
                   const int* __restrict__ kf_perm,
                   const int* __restrict__ kf_start,
                   const int* __restrict__ lm_perm,
                   const int* __restrict__ lm_start,
                   const float* __restrict__ baseline_p, int body,
                   int per_obs, int K, int L, int O, int lm_blocks,
                   float* __restrict__ Hpp, float* __restrict__ bp,
                   float* __restrict__ Bt, float* __restrict__ Hll,
                   float* __restrict__ bl, float* __restrict__ cost,
                   float* __restrict__ scratch) {
    const float baseline = *baseline_p;
    const float sign = body ? -1.0f : 1.0f;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if ((int)blockIdx.x < K) {
        // ---- keyframe k: Hpp, bp and the partial cost
        __shared__ float red[NWARPS][NACC];
        __shared__ bool last;
        const int k = blockIdx.x;
        float acc[NACC];
#pragma unroll
        for (int q = 0; q < NACC; ++q) acc[q] = 0.0f;
        for (int s = kf_start[k] + tid; s < kf_start[k + 1]; s += THREADS) {
            Terms T;
            obs_terms(kf_perm[s], R, t, X, obs_kf, obs_lm, obs_uv, obs_ur,
                      obs_info, obs_mask, baseline, sign, T);
            const int rows = T.stereo ? 3 : 2;
            for (int i = 0; i < rows; ++i) {
                int q = 0;
                for (int a = 0; a < 6; ++a) {
                    const float wa = T.w * T.Jp[i][a];
                    for (int b = a; b < 6; ++b) acc[q++] += wa * T.Jp[i][b];
                }
                for (int a = 0; a < 6; ++a)
                    acc[21 + a] += T.w * T.Jp[i][a] * T.r[i];
            }
            acc[27] += T.w * (T.r[0] * T.r[0] + T.r[1] * T.r[1] +
                              T.r[2] * T.r[2]);
        }
#pragma unroll
        for (int q = 0; q < NACC; ++q) {
            float v = acc[q];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                v += __shfl_xor_sync(0xffffffffu, v, off);
            if (lane == 0) red[warp][q] = v;
        }
        __syncthreads();
        if (tid < NACC) {
            float s = 0.0f;
            for (int wq = 0; wq < NWARPS; ++wq) s += red[wq][tid];
            if (tid < 21) {
                int a = 0, q = tid;
                while (q >= 6 - a) { q -= 6 - a; ++a; }
                const int b = a + q;
                Hpp[36 * (size_t)k + 6 * a + b] = s;
                Hpp[36 * (size_t)k + 6 * b + a] = s;
            } else if (tid < 27) {
                bp[6 * (size_t)k + tid - 21] = -s;
            } else {
                scratch[k] = s;
            }
        }
        // the last keyframe block sums the partial costs in keyframe order
        __threadfence();
        __syncthreads();
        if (tid == 0) {
            unsigned int* ticket = (unsigned int*)(scratch + K);
            last = atomicAdd(ticket, 1u) == (unsigned int)(K - 1);
        }
        __syncthreads();
        if (last && tid == 0) {
            volatile float* part = scratch;
            float s = 0.0f;
            for (int q = 0; q < K; ++q) s += part[q];
            *cost = s;
            *(unsigned int*)(scratch + K) = 0u;
        }
        return;
    }
    const int b0 = blockIdx.x - K;
    // the landmark blocks' per-observation values, or the slot blocks'
    // staged output
    __shared__ __align__(16) float sbuf[THREADS * NV];
    __shared__ int skf[THREADS];
    if (b0 < lm_blocks) {
        // ---- landmarks l0 .. l1 - 1: Bt rows, Hll, bl
        const int l0 = b0 * LM_PER_BLOCK, l1 = min(l0 + LM_PER_BLOCK, L);
        if (!per_obs) {
            // the block zeroes its landmarks' rows, one stretch
            zero_block(Bt + (size_t)l0 * K * 18, (size_t)(l1 - l0) * K * 18,
                       tid);
        }
        const int nv = per_obs ? 12 : NV;
        const bool mine = tid < l1 - l0;
        const int l = l0 + tid;
        int s = mine ? lm_start[l] : 0;
        const int s_end = mine ? lm_start[l + 1] : 0;
        float h[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0}, g[3] = {0, 0, 0};
        float c[18];
        int kc = -1;
        const int S1 = lm_start[l1];
        for (int base = lm_start[l0]; base < S1; base += THREADS) {
            // every thread one observation of the block's segment...
            __syncthreads();
            if (base + tid < S1) {
                const int o = lm_perm[base + tid];
                Terms T;
                obs_terms(o, R, t, X, obs_kf, obs_lm, obs_uv, obs_ur,
                          obs_info, obs_mask, baseline, sign, T);
                float* v = sbuf + tid * nv;
                if (!per_obs) {
                    skf[tid] = obs_kf[o];
                    coupling(T, __fmul_rn(T.w, lm_opt[obs_lm[o]] ? 1.0f
                                                                  : 0.0f),
                             v);
                    v += 18;
                }
                landmark_parts(T, v, v + 9);
            }
            __syncthreads();
            // ...then a thread a landmark adds its observations' values in
            // (landmark, keyframe) order
            if (!mine) continue;
            for (const int e = min(s_end, base + THREADS); s < e; ++s) {
                const float* v = sbuf + (s - base) * nv;
                if (!per_obs) {
                    const int k = skf[s - base];
                    if (k != kc) {
                        if (kc >= 0)
                            store18(Bt + ((size_t)l * K + kc) * 18, c);
#pragma unroll
                        for (int q = 0; q < 18; ++q) c[q] = 0.0f;
                        kc = k;
                    }
#pragma unroll
                    for (int q = 0; q < 18; ++q) c[q] = __fadd_rn(v[q], c[q]);
                    v += 18;
                }
#pragma unroll
                for (int q = 0; q < 9; ++q) h[q] = __fadd_rn(v[q], h[q]);
#pragma unroll
                for (int q = 0; q < 3; ++q) g[q] = __fadd_rn(v[9 + q], g[q]);
            }
        }
        if (!mine) return;
        if (!per_obs && kc >= 0) store18(Bt + ((size_t)l * K + kc) * 18, c);
        for (int q = 0; q < 9; ++q) Hll[9 * (size_t)l + q] = h[q];
        for (int q = 0; q < 3; ++q) bl[3 * (size_t)l + q] = -g[q];
        return;
    }
    // ---- per-observation mode: slots o0 .. o0 + 31 of Wpl
    const int o0 = (b0 - lm_blocks) * THREADS + warp * 32, o = o0 + lane;
    if (o0 >= O) return;
    const int n = min(32, O - o0);
    float* dst = Bt + (size_t)o0 * 18;
    const bool act = o < O && obs_mask[o];
    if (!__ballot_sync(0xffffffffu, act)) {
        zero_n(dst, (size_t)n * 18, lane, 32);
        return;
    }
    float v[18];
    if (act) {
        Terms T;
        obs_terms(o, R, t, X, obs_kf, obs_lm, obs_uv, obs_ur, obs_info,
                  obs_mask, baseline, sign, T);
        coupling(T, T.w, v);
#pragma unroll
        for (int q = 0; q < 18; ++q) v[q] = __fadd_rn(v[q], 0.0f);
    } else {
#pragma unroll
        for (int q = 0; q < 18; ++q) v[q] = 0.0f;
    }
    float* st = sbuf + warp * 32 * 18;
#pragma unroll
    for (int q = 0; q < 18; ++q) st[18 * lane + q] = v[q];
    __syncwarp();
    const int n4 = n * 18 / 4;
    const float4* s4 = reinterpret_cast<const float4*>(st);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int q = lane; q < n4; q += 32) d4[q] = s4[q];
    if (lane == 0 && (n & 1))
        reinterpret_cast<float2*>(dst)[n * 9 - 1] =
            reinterpret_cast<const float2*>(st)[n * 9 - 1];
}

extern "C" int ba_assemble(const void* R, const void* t, const void* X,
                           const void* obs_kf, const void* obs_lm,
                           const void* obs_uv, const void* obs_ur,
                           const void* obs_info, const void* obs_mask,
                           const void* lm_opt, const void* kf_perm,
                           const void* kf_start, const void* lm_perm,
                           const void* lm_start, const void* baseline,
                           int body, int per_obs, int K, int L, int O,
                           void* Hpp,
                           void* bp, void* Bt, void* Hll, void* bl,
                           void* cost, void* scratch, void* stream) {
    const int lm_blocks = (L + LM_PER_BLOCK - 1) / LM_PER_BLOCK;
    const long long blocks = (long long)K + lm_blocks +
                             (per_obs ? ((long long)O + THREADS - 1) / THREADS
                                      : 0);
    if (blocks == 0) return 0;
    if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    ba_assemble_kernel<<<(unsigned)blocks, THREADS, 0,
                         (cudaStream_t)stream>>>(
        (const float*)R, (const float*)t, (const float*)X,
        (const int*)obs_kf, (const int*)obs_lm, (const float*)obs_uv,
        (const float*)obs_ur, (const float*)obs_info,
        (const uint8_t*)obs_mask, (const uint8_t*)lm_opt,
        (const int*)kf_perm, (const int*)kf_start, (const int*)lm_perm,
        (const int*)lm_start, (const float*)baseline, body, per_obs, K, L, O,
        lm_blocks, (float*)Hpp, (float*)bp, (float*)Bt, (float*)Hll,
        (float*)bl, (float*)cost, (float*)scratch);
    return (int)cudaGetLastError();
}
