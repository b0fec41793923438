// K4: the bundle adjustment's observation assembly at one state, in one
// launch: every observation's residual, Jacobians and Huber weight, and
// their block sums Hpp (K, 6, 6), bp (K, 6), the dense coupling
// Bt (L, K, 6, 3), Hll (L, 3, 3), bl (L, 3), with the robust cost. In its
// per-observation mode (`per_obs` = 1, the global BA's PCG solve) it
// writes the coupling per observation instead, Wpl (O, 6, 3) = Jp^T w Jl
// in observation order, unweighted by lm_opt (the reference's
// optim/ba.py:_assemble_blocks), and no dense Bt exists.
//
// Replaces the assembly of morb_slam_tpu/optim/ba.py:ba_solve (terms_of and
// the block sums of lm_step) and the visual blocks of
// morb_slam_tpu/optim/vi_ba.py:_lm_step / _total_cost (_visual_terms), which
// differ only in the pose Jacobian: camera tangent [I | -hat(Xc)] against
// body tangent [-I | hat(Xc)] (`body` = 1). Every keyframe insert runs one
// local BA (5 or 6 LM iterations, one launch per state).
//
// What bounds it on an H100: bytes. It reads ~33 B per observation and
// writes the dense coupling, 72 B per (landmark, keyframe) pair (8 MB at
// 6,144 landmarks x 18 keyframes), against ~400 flops per observation.
//
// Design: observations are sorted once per solve (by the wrapper, on the
// card) by keyframe and by (landmark, keyframe); every sum then runs over a
// segment in that fixed order, without float atomics, so two launches on
// the same input give the same bits. Blocks [0, K) each own one keyframe:
// 256 threads stride over its observations and accumulate the 21 upper
// entries of Hpp, the 6 of Jp^T w r and the cost; a fixed-order warp
// butterfly and a pass over the 8 warps reduce them. The keyframes' partial
// costs land in scratch; the last keyframe block to finish (an integer
// ticket) sums them in keyframe order. Blocks [K, ...) give one warp to each
// landmark: the warp zeroes the landmark's K x 18 row of Bt, then lane 0
// walks its observations in (landmark, keyframe) order, adding each one's
// coupling block into Bt[l, k] and its Hll and bl terms. Masked observations
// sort past every segment and add nothing; the plain version adds them with
// weight 0. Per-observation mode skips the row zeroing and stores each
// observation's block at Wpl[o]: observation order is the layout of the
// reference's Wpl, needs no index map, and in the global problem (laid out
// keyframe-major) it is the keyframe pass's reading order; the wrapper
// zeroes Wpl, so masked observations hold zero blocks.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define NWARPS (THREADS / 32)
#define NACC 28  // 21 Hpp + 6 g + cost

#define HUBER2_MONO 5.991f
#define HUBER2_STEREO 7.815f

struct Terms {
    float r[3];
    float Jp[3][6];
    float Jl[3][3];
    float w;
    bool stereo;
};

// optim/ba.py:_obs_terms for observation o (robust weights)
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
        Xc[i] = Rk[3 * i] * X0 + Rk[3 * i + 1] * X1 + Rk[3 * i + 2] * X2 +
                tk[i];
    const float x = Xc[0], y = Xc[1], z = Xc[2];
    const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;
    const float iz = 1.0f / zs, iz2 = iz * iz;
    const float ur = obs_ur[o];
    T.stereo = isfinite(ur);
    T.r[0] = x * iz - obs_uv[2 * (size_t)o];
    T.r[1] = y * iz - obs_uv[2 * (size_t)o + 1];
    T.r[2] = T.stereo ? (x - baseline) * iz - ur : 0.0f;
    float Jpt[3][3] = {{iz, 0.0f, -x * iz2},
                       {0.0f, iz, -y * iz2},
                       {T.stereo ? iz : 0.0f, 0.0f,
                        T.stereo ? -(x - baseline) * iz2 : 0.0f}};
    for (int i = 0; i < 3; ++i) {
        const float a = Jpt[i][0], b = Jpt[i][1], c = Jpt[i][2];
        // J_pt [I | -hat(Xc)], negated for the body tangent
        T.Jp[i][0] = sign * a;
        T.Jp[i][1] = sign * b;
        T.Jp[i][2] = sign * c;
        T.Jp[i][3] = sign * (-b * z + c * y);
        T.Jp[i][4] = sign * (a * z - c * x);
        T.Jp[i][5] = sign * (-a * y + b * x);
        for (int j = 0; j < 3; ++j)
            T.Jl[i][j] = a * Rk[j] + b * Rk[3 + j] + c * Rk[6 + j];
    }
    const float info = obs_info[o];
    const float chi2 =
        (T.r[0] * T.r[0] + T.r[1] * T.r[1] + T.r[2] * T.r[2]) * info;
    const float d2 = T.stereo ? HUBER2_STEREO : HUBER2_MONO;
    const float hub = chi2 <= d2 ? 1.0f : sqrtf(d2 / fmaxf(chi2, 1e-12f));
    T.w = (obs_mask[o] && z > 0.0f) ? info * hub : 0.0f;
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
                   int per_obs, int K,
                   int L, float* __restrict__ Hpp, float* __restrict__ bp,
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
    // ---- landmark l: Bt[l], Hll[l], bl[l]
    const int l = (blockIdx.x - K) * NWARPS + warp;
    if (l >= L) return;
    float* Brow = per_obs ? Bt : Bt + (size_t)l * K * 18;
    if (!per_obs) {
        for (int q = lane; q < K * 18; q += 32) Brow[q] = 0.0f;
        __syncwarp();
    }
    if (lane != 0) return;
    const float lmw = (per_obs || lm_opt[l]) ? 1.0f : 0.0f;
    float h[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0}, g[3] = {0, 0, 0};
    for (int s = lm_start[l]; s < lm_start[l + 1]; ++s) {
        const int o = lm_perm[s];
        Terms T;
        obs_terms(o, R, t, X, obs_kf, obs_lm, obs_uv, obs_ur, obs_info,
                  obs_mask, baseline, sign, T);
        float* Bk = per_obs ? Bt + 18 * (size_t)o : Brow + 18 * obs_kf[o];
        const float wb = T.w * lmw;
        for (int a = 0; a < 6; ++a)
            for (int b = 0; b < 3; ++b) {
                float v = 0.0f;
                for (int i = 0; i < 3; ++i) v += T.Jp[i][a] * wb * T.Jl[i][b];
                Bk[3 * a + b] += v;
            }
        for (int a = 0; a < 3; ++a) {
            for (int b = 0; b < 3; ++b) {
                float v = 0.0f;
                for (int i = 0; i < 3; ++i) v += T.Jl[i][a] * T.w * T.Jl[i][b];
                h[3 * a + b] += v;
            }
            float v = 0.0f;
            for (int i = 0; i < 3; ++i) v += T.Jl[i][a] * T.w * T.r[i];
            g[a] += v;
        }
    }
    for (int q = 0; q < 9; ++q) Hll[9 * (size_t)l + q] = h[q];
    for (int q = 0; q < 3; ++q) bl[3 * (size_t)l + q] = -g[q];
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
    (void)O;
    const int blocks = K + (L + NWARPS - 1) / NWARPS;
    if (blocks == 0) return 0;
    ba_assemble_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)R, (const float*)t, (const float*)X,
        (const int*)obs_kf, (const int*)obs_lm, (const float*)obs_uv,
        (const float*)obs_ur, (const float*)obs_info,
        (const uint8_t*)obs_mask, (const uint8_t*)lm_opt,
        (const int*)kf_perm, (const int*)kf_start, (const int*)lm_perm,
        (const int*)lm_start, (const float*)baseline, body, per_obs, K, L,
        (float*)Hpp, (float*)bp, (float*)Bt, (float*)Hll, (float*)bl,
        (float*)cost, (float*)scratch);
    return (int)cudaGetLastError();
}
