// K7: the rectified stereo match's SAD refinement and dispersion filter in
// one launch, a warp per left keypoint.
//
// Replaces morb_slam_tpu/ops/stereo.py:match_stereo from the row search's
// argmin to its StereoMatches (:64-120): the matched right x, the 11x11
// SAD sweep and parabola fit, the disparity gate, the median of the matched
// SADs and the 1.5 x 1.4 x median test, the depth. The plain version is
// ops/stereo.py:refine_and_filter_plain (sad_refine_plain, then
// filter_matches).
//
// Per keypoint: the 11x11 left window minus its centre pixel, against 11
// right windows (each minus its own centre) over +-5 px of the matched right
// x, on the reference's 12-px edge-padded images; SAD of each, argmin with
// the first offset winning ties, a parabola through (k-1, k, k+1) clipped to
// +-1 and zero at the ends of the sweep. Then the filter: disparity in
// (0, max_d), the median of the matched keypoints' SADs (an unmatched one
// counts as +inf; the element of rank n_m / 2, as torch.sort places it),
// keep where sad <= 2.1 x median, depth = bf / disparity as torch computes
// it (reciprocal, then the product: two roundings), -1 elsewhere.
//
// What bounds it on an H100: at the main path's 1200 keypoints neither
// bytes nor operations: ~5.4 kflop and at most 352 distinct pixels (1.4 KB)
// per keypoint, 6.5 Mflop and < 1.7 MB in all, ~0.5 us at 3.35 TB/s. The
// time is launch and load latency, and the serial tail of the last block;
// as torch ops the filter is ~28 kernels (a sort, a gather, the gates),
// each a host dispatch.
//
// Design: 8 warps per block, one keypoint per warp. The warp gathers the
// matched right x itself, then stages its left window (121 px) and right
// strip (11 x 21 px) in shared memory a row at a time: lanes 0-20 read the
// strip's row, lanes 21-31 the window's, 11 loads a lane with no division;
// the edge pad is a clamp of the source coordinate, and the start of each
// window is clamped into the padded image as the reference's dynamic_slice
// does. Each lane then takes pixels lane, lane + 32, ... of the window and
// accumulates all 11 candidate SADs in registers; a butterfly of warp
// shuffles sums each. Rounding follows the reference: half-to-even
// positions (__float2int_rn, as jnp.round), and every subtraction and sum
// with __fsub_rn / __fadd_rn. On integer-valued images every partial sum
// is an integer below 2^24, so the sums, the argmin and the best SAD equal
// the plain version's bitwise in any order.
// The median needs every keypoint's SAD: each block counts itself done on
// an integer ticket after a __threadfence, and the last block reads the
// others' results through L2 once (the first 2,816 keys into shared
// memory), selects the median exactly (a 4-pass 8-bit radix select on the
// float bits: SADs are non-negative, and non-negative floats and +inf
// order as uint32) and writes all N outputs; then it resets the ticket for
// the next launch on the stream. No float atomics.
// Without `matched` the launch is the sweep alone (sad_refine); with it,
// ur_out and sad_out are the last block's scratch and k_out is null.
#include <cuda_runtime.h>

#define SAD_W 5
#define SAD_L 5
#define PAD (SAD_W + SAD_L + 2)
#define WIN (2 * SAD_W + 1)
#define STRIP (WIN + 2 * SAD_L)
#define NCAND (2 * SAD_L + 1)
#define WARPS 8
#define THREADS (WARPS * 32)
#define INF_BITS 0x7f800000u
// keys the last block keeps in shared memory (the rest it reads from L2)
#define SEL_CAP (WARPS * (WIN * WIN + WIN * STRIP))

static_assert(STRIP + WIN == 32, "a row of the strip and the window is a warp");
static_assert(THREADS == 256, "one thread a radix bin");

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

// the block's sum of one value a thread
__device__ unsigned block_sum(unsigned v, unsigned* s_warp) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    v = __reduce_add_sync(0xffffffffu, v);
    if (lane == 0) s_warp[warp] = v;
    __syncthreads();
    unsigned t = 0;
    for (int w = 0; w < WARPS; ++w) t += s_warp[w];
    __syncthreads();
    return t;
}

__global__ void __launch_bounds__(THREADS)
stereo_sad_kernel(const float* __restrict__ img_l,
                  const float* __restrict__ img_r, int H, int W,
                  const float2* __restrict__ uv_l,
                  const float* __restrict__ u0_r,
                  const float2* __restrict__ uv_r,
                  const int* __restrict__ best_idx, int NR,
                  const unsigned char* __restrict__ matched, float max_d,
                  float disp_coef, float bf, int N,
                  float* __restrict__ ur_out, float* __restrict__ sad_out,
                  int* __restrict__ k_out, float* __restrict__ u_right,
                  float* __restrict__ depth, unsigned char* __restrict__ valid,
                  unsigned int* __restrict__ ticket) {
    // the warps' windows and strips; in the last block, the keys
    __shared__ float s_win[SEL_CAP];
    __shared__ unsigned s_hist[THREADS];
    __shared__ unsigned s_warp[WARPS];
    __shared__ unsigned s_sel[2];
    __shared__ int s_last;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int i = blockIdx.x * WARPS + warp;
    if (i < N) {             // warp-uniform; only __syncwarp inside
        const float2 p = uv_l[i];
        float ur;
        if (u0_r) {
            ur = u0_r[i];
        } else {
            int j = best_idx[i];
            if (j < 0) j += NR;          // torch's negative index
            ur = uv_r[j].x;
        }
        const int Hp = H + 2 * PAD, Wp = W + 2 * PAD;
        const int yi = __float2int_rn(p.y) + PAD;
        const int xli = __float2int_rn(p.x) + PAD;
        const int xri = __float2int_rn(ur) + PAD;
        const int y0 = clampi(yi - SAD_W, 0, Hp - WIN) - PAD;
        const int xl0 = clampi(xli - SAD_W, 0, Wp - WIN) - PAD;
        const int xr0 = clampi(xri - SAD_W - SAD_L, 0, Wp - STRIP) - PAD;
        float* sl = s_win + warp * WIN * WIN;
        float* sr = s_win + WARPS * WIN * WIN + warp * WIN * STRIP;
        const bool right = lane < STRIP;
        const float* img = right ? img_r : img_l;
        const int xx = right ? clampi(xr0 + lane, 0, W - 1)
                             : clampi(xl0 + lane - STRIP, 0, W - 1);
        float* dst = right ? sr + lane : sl + lane - STRIP;
        const int pitch = right ? STRIP : WIN;
#pragma unroll
        for (int r = 0; r < WIN; ++r) {
            const int yy = clampi(y0 + r, 0, H - 1);
            dst[r * pitch] = __ldg(img + (size_t)yy * W + xx);
        }
        __syncwarp();
        const float cl = sl[SAD_W * WIN + SAD_W];
        float acc[NCAND];
#pragma unroll
        for (int k = 0; k < NCAND; ++k) acc[k] = 0.0f;
        for (int t = lane; t < WIN * WIN; t += 32) {
            const int r = t / WIN, c = t % WIN;
            const float wl = __fsub_rn(sl[t], cl);
#pragma unroll
            for (int k = 0; k < NCAND; ++k) {
                const float wr = __fsub_rn(sr[r * STRIP + c + k],
                                           sr[SAD_W * STRIP + SAD_W + k]);
                acc[k] = __fadd_rn(acc[k], fabsf(__fsub_rn(wl, wr)));
            }
        }
#pragma unroll
        for (int k = 0; k < NCAND; ++k) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                acc[k] = __fadd_rn(acc[k], __shfl_xor_sync(0xffffffffu,
                                                           acc[k], off));
        }
        if (lane == 0) {
            int kb = 0;
            float s1 = acc[0];
#pragma unroll
            for (int k = 1; k < NCAND; ++k)
                if (acc[k] < s1) {
                    s1 = acc[k];
                    kb = k;
                }
            // static register indices only: acc[] stays out of local memory
            float s0 = 0.0f, s2 = 0.0f;
#pragma unroll
            for (int k = 0; k < NCAND; ++k) {
                if (k == max(kb - 1, 0)) s0 = acc[k];
                if (k == min(kb + 1, 2 * SAD_L)) s2 = acc[k];
            }
            const float denom = __fsub_rn(__fadd_rn(s0, s2),
                                          __fmul_rn(2.0f, s1));
            float delta = 0.0f;
            if (fabsf(denom) > 1e-6f)
                delta = __fdiv_rn(__fsub_rn(s0, s2), __fmul_rn(2.0f, denom));
            delta = fminf(fmaxf(delta, -1.0f), 1.0f);
            if (kb == 0 || kb == 2 * SAD_L) delta = 0.0f;
            const float ur_ref = __fadd_rn(__fadd_rn(ur, (float)(kb - SAD_L)),
                                           delta);
            ur_out[i] = ur_ref;
            sad_out[i] = s1;
            if (k_out) k_out[i] = kb;
            if (matched) {
                // the disparity gate; the last block turns the flag into
                // the filter's verdict
                const float disp = __fsub_rn(p.x, ur_ref);
                valid[i] = matched[i] && disp > 0.0f && disp < max_d;
            }
        }
    }
    if (!matched) return;                  // the sweep alone
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
        s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    const int tid = threadIdx.x;
    // the median: rank n_m / 2 among the keys (SAD bits, +inf unmatched),
    // read from L2 once: the first SEL_CAP into shared memory, counted and
    // put in the first pass's bins on the way
    unsigned* s_key = reinterpret_cast<unsigned*>(s_win);
    s_hist[tid] = 0;
    __syncthreads();
    unsigned c = 0;
#pragma unroll 4
    for (int q = tid; q < N; q += THREADS) {
        const bool m = __ldcg(valid + q);
        const unsigned sb = __float_as_uint(__ldcg(sad_out + q));
        const unsigned key = m ? sb : INF_BITS;
        if (q < SEL_CAP) s_key[q] = key;
        c += m;
        atomicAdd(&s_hist[key >> 24], 1u);
    }
    const unsigned n_m = block_sum(c, s_warp);
    unsigned k = min(n_m / 2, (unsigned)(N - 1));
    unsigned prefix = 0, mask = 0;
    for (int shift = 24; shift >= 0; shift -= 8) {
        if (shift != 24) {
            s_hist[tid] = 0;
            __syncthreads();
#pragma unroll 4
            for (int q = tid; q < N; q += THREADS) {
                unsigned key;
                if (q < SEL_CAP) {
                    key = s_key[q];
                } else {
                    const bool m = __ldcg(valid + q);
                    const unsigned sb = __float_as_uint(__ldcg(sad_out + q));
                    key = m ? sb : INF_BITS;
                }
                if ((key & mask) == prefix)
                    atomicAdd(&s_hist[(key >> shift) & 255u], 1u);
            }
            __syncthreads();
        }
        // inclusive scan of the bins: warps, then the warps' totals
        const unsigned h = s_hist[tid];
        unsigned incl = h;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const unsigned o = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += o;
        }
        if (lane == 31) s_warp[warp] = incl;
        __syncthreads();
        for (int w = 0; w < warp; ++w) incl += s_warp[w];
        if (incl - h <= k && k < incl) {
            s_sel[0] = tid;
            s_sel[1] = k - (incl - h);
        }
        __syncthreads();
        prefix |= s_sel[0] << shift;
        mask |= 255u << shift;
        k = s_sel[1];
        __syncthreads();
    }
    const float thr = __fmul_rn(disp_coef, __uint_as_float(prefix));
#pragma unroll 4
    for (int q = tid; q < N; q += THREADS) {
        const float s = __ldcg(sad_out + q);
        const float ur = __ldcg(ur_out + q);
        const float ul = uv_l[q].x;
        const bool keep = __ldcg(valid + q) && s <= thr;
        float d = -1.0f, u = -1.0f;
        if (keep) {
            d = __fmul_rn(__frcp_rn(__fsub_rn(ul, ur)), bf);
            u = ur;
        }
        u_right[q] = u;
        depth[q] = d;
        valid[q] = keep;
    }
    if (tid == 0) *ticket = 0u;
}

// The whole tail of match_stereo (`matched` given: the filter's outputs
// too, k_out null) or the sweep alone (`matched` null; u0_r the right x,
// or null and the right x gathered from uv_r at best_idx). N > 0: the
// caller returns empty outputs for N == 0 without a launch.
extern "C" int stereo_sad(const void* img_l, const void* img_r, int H, int W,
                          const void* uv_l, const void* u0_r,
                          const void* uv_r, const void* best_idx, int NR,
                          const void* matched, float max_d, float disp_coef,
                          float bf, int N, void* ur_out, void* sad_out,
                          void* k_out, void* u_right, void* depth,
                          void* valid, void* ticket, void* stream) {
    const int blocks = (N + WARPS - 1) / WARPS;
    stereo_sad_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)img_l, (const float*)img_r, H, W, (const float2*)uv_l,
        (const float*)u0_r, (const float2*)uv_r, (const int*)best_idx, NR,
        (const unsigned char*)matched, max_d, disp_coef, bf, N,
        (float*)ur_out, (float*)sad_out, (int*)k_out, (float*)u_right,
        (float*)depth, (unsigned char*)valid, (unsigned int*)ticket);
    return (int)cudaGetLastError();
}
