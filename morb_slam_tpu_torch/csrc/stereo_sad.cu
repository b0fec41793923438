// K7: stereo SAD subpixel refinement, one warp per left keypoint.
//
// Replaces the vmapped `one` of morb_slam_tpu/ops/stereo.py:match_stereo
// (the 11x11 SAD sweep and parabola fit after the row search).
//
// Per keypoint: the 11x11 left window minus its centre pixel, against 11
// right windows (each minus its own centre) over +-5 px of the matched right
// x, on the reference's 12-px edge-padded images; SAD of each, argmin with
// the first offset winning ties, a parabola through (k-1, k, k+1) clipped to
// +-1 and zero at the ends of the sweep. Outputs the refined right x, the
// best SAD and the best offset.
//
// What bounds it on an H100: bytes, and at the main path's 1200 keypoints
// neither: ~5.4 kflop and at most 352 distinct pixels (1.4 KB) per keypoint,
// 6.5 Mflop and < 1.7 MB in all, ~0.5 us at 3.35 TB/s. The time is launch
// and load latency, so the design keeps each warp's loads few and parallel.
//
// Design: 8 warps per block, one keypoint per warp. The warp stages its
// left window (121 px) and right strip (11 x 21 px) in shared memory with
// clamped reads: the edge pad becomes a clamp of the source coordinate, and
// the start of each window is clamped into the padded image as the
// reference's dynamic_slice does. Each lane then takes pixels lane,
// lane + 32, ... of the window and accumulates all 11 candidate SADs in
// registers; a butterfly of warp shuffles sums each. Rounding follows the
// reference: half-to-even positions (__float2int_rn, as jnp.round), and
// every subtraction and sum with __fsub_rn / __fadd_rn. On integer-valued
// images every partial sum is an integer below 2^24, so the sums, the
// argmin and the best SAD equal the plain version's bitwise in any order.
#include <cuda_runtime.h>

#define SAD_W 5
#define SAD_L 5
#define PAD (SAD_W + SAD_L + 2)
#define WIN (2 * SAD_W + 1)
#define STRIP (WIN + 2 * SAD_L)
#define NCAND (2 * SAD_L + 1)
#define WARPS 8

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(WARPS * 32)
stereo_sad_kernel(const float* __restrict__ img_l,
                  const float* __restrict__ img_r, int H, int W,
                  const float2* __restrict__ uv_l,
                  const float* __restrict__ u0_r, int N,
                  float* __restrict__ ur_out, float* __restrict__ sad_out,
                  int* __restrict__ k_out) {
    __shared__ float s_l[WARPS][WIN * WIN];
    __shared__ float s_r[WARPS][WIN * STRIP];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int i = blockIdx.x * WARPS + warp;
    if (i >= N) return;      // the whole warp leaves; only __syncwarp below
    const float2 p = uv_l[i];
    const float ur = u0_r[i];
    const int Hp = H + 2 * PAD, Wp = W + 2 * PAD;
    const int yi = __float2int_rn(p.y) + PAD;
    const int xli = __float2int_rn(p.x) + PAD;
    const int xri = __float2int_rn(ur) + PAD;
    const int y0 = clampi(yi - SAD_W, 0, Hp - WIN) - PAD;
    const int xl0 = clampi(xli - SAD_W, 0, Wp - WIN) - PAD;
    const int xr0 = clampi(xri - SAD_W - SAD_L, 0, Wp - STRIP) - PAD;
    float* sl = s_l[warp];
    float* sr = s_r[warp];
    for (int t = lane; t < WIN * WIN; t += 32) {
        const int yy = clampi(y0 + t / WIN, 0, H - 1);
        const int xx = clampi(xl0 + t % WIN, 0, W - 1);
        sl[t] = __ldg(img_l + (size_t)yy * W + xx);
    }
    for (int t = lane; t < WIN * STRIP; t += 32) {
        const int yy = clampi(y0 + t / STRIP, 0, H - 1);
        const int xx = clampi(xr0 + t % STRIP, 0, W - 1);
        sr[t] = __ldg(img_r + (size_t)yy * W + xx);
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
            acc[k] = __fadd_rn(acc[k], __shfl_xor_sync(0xffffffffu, acc[k],
                                                       off));
    }
    if (lane != 0) return;
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
    const float denom = __fsub_rn(__fadd_rn(s0, s2), __fmul_rn(2.0f, s1));
    float delta = 0.0f;
    if (fabsf(denom) > 1e-6f)
        delta = __fdiv_rn(__fsub_rn(s0, s2), __fmul_rn(2.0f, denom));
    delta = fminf(fmaxf(delta, -1.0f), 1.0f);
    if (kb == 0 || kb == 2 * SAD_L) delta = 0.0f;
    ur_out[i] = __fadd_rn(__fadd_rn(ur, (float)(kb - SAD_L)), delta);
    sad_out[i] = s1;
    k_out[i] = kb;
}

extern "C" int stereo_sad(const void* img_l, const void* img_r, int H, int W,
                          const void* uv_l, const void* u0_r, int N,
                          void* ur_out, void* sad_out, void* k_out,
                          void* stream) {
    if (N == 0) return 0;
    const int blocks = (N + WARPS - 1) / WARPS;
    stereo_sad_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const float*)img_l, (const float*)img_r, H, W, (const float2*)uv_l,
        (const float*)u0_r, N, (float*)ur_out, (float*)sad_out, (int*)k_out);
    return (int)cudaGetLastError();
}
