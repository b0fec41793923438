// K2: intensity-centroid orientation + rotated BRIEF-256 for the keypoints
// of one pyramid level, one warp per keypoint.
//
// Replaces morb_slam_tpu/ops/orb_descriptor.py:compute_orientations and
// compute_descriptors (called from morb_slam_tpu/frontend.py:_extract_level).
//
// What bounds it on an H100: neither bytes nor operations at these sizes.
// Per keypoint it reads 709 pixels of the raw level (the radius-15 disc)
// and 512 of the blurred level and writes 36 bytes; over the 1200 keypoints
// of a frame that is about 6 MB of mostly L2-resident reads (~1.8 us at
// 3.35 TB/s) and ~6 Mflop. A launch of a few hundred warps is latency bound.
// The reference program gathers a padded 31x31 and 41x41 patch per
// keypoint into device memory; here nothing but the results leaves the SM.
//
// Design: one warp per keypoint. Lane u < 31 walks column u - 15 of the
// disc (lanes of a row read neighbouring pixels), the two moments reduce by
// warp shuffles, then atan2f / sincosf give the rotation. The 256 pair
// tests run 8 per lane from the pattern in __constant__ memory (uploaded
// once by orb_set_pattern); __ballot_sync packs word w from test 32*w+lane.
// Sample offsets round half to even (__float2int_rn), as jnp.round does, and
// the products are kept un-fused (__fmul_rn) so the rounding matches the
// plain version. Reflect padding (no edge repeat) is an index reflection.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PATCH_R 15
#define WARPS_PER_BLOCK 8

__constant__ int c_pattern[256 * 4];

__device__ __forceinline__ int reflect(int i, int n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * (n - 1) - i;
    return i;
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
orb_describe_kernel(const float* __restrict__ img, const float* __restrict__ blur,
                    int H, int W, const int* __restrict__ yx, int n,
                    float* __restrict__ angle_out, int* __restrict__ desc_out) {
    const int k = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (k >= n) return;  // the whole warp leaves together
    const int y = yx[2 * k], x = yx[2 * k + 1];

    float m10 = 0.0f, m01 = 0.0f;
    if (lane < 2 * PATCH_R + 1) {
        const int u = lane - PATCH_R;
        const int gx = reflect(x + u, W);
        for (int v = -PATCH_R; v <= PATCH_R; ++v) {
            if (u * u + v * v <= PATCH_R * PATCH_R) {
                const float p = img[(size_t)reflect(y + v, H) * W + gx];
                m10 += (float)u * p;
                m01 += (float)v * p;
            }
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        m10 += __shfl_xor_sync(0xffffffffu, m10, off);
        m01 += __shfl_xor_sync(0xffffffffu, m01, off);
    }
    const float ang = atan2f(m01, m10);
    float sa, ca;
    sincosf(ang, &sa, &ca);

#pragma unroll
    for (int w = 0; w < 8; ++w) {
        const int t = 4 * (32 * w + lane);
        const float px1 = (float)c_pattern[t], py1 = (float)c_pattern[t + 1];
        const float px2 = (float)c_pattern[t + 2], py2 = (float)c_pattern[t + 3];
        const int x1 = __float2int_rn(__fsub_rn(__fmul_rn(px1, ca), __fmul_rn(py1, sa)));
        const int y1 = __float2int_rn(__fadd_rn(__fmul_rn(px1, sa), __fmul_rn(py1, ca)));
        const int x2 = __float2int_rn(__fsub_rn(__fmul_rn(px2, ca), __fmul_rn(py2, sa)));
        const int y2 = __float2int_rn(__fadd_rn(__fmul_rn(px2, sa), __fmul_rn(py2, ca)));
        const float a = blur[(size_t)reflect(y + y1, H) * W + reflect(x + x1, W)];
        const float b = blur[(size_t)reflect(y + y2, H) * W + reflect(x + x2, W)];
        const unsigned bits = __ballot_sync(0xffffffffu, a < b);
        if (lane == 0) desc_out[8 * k + w] = (int)bits;
    }
    if (lane == 0) angle_out[k] = ang;
}

extern "C" int orb_set_pattern(const int* host_pattern) {
    cudaMemcpyToSymbol(c_pattern, host_pattern, sizeof(int) * 256 * 4);
    return (int)cudaGetLastError();
}

extern "C" int orb_describe(const float* img, const float* blur, int H, int W,
                            const int* yx, int n, float* angle, int* desc,
                            void* stream) {
    if (n == 0) return 0;
    const int blocks = (n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    orb_describe_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0, (cudaStream_t)stream>>>(
        img, blur, H, W, yx, n, angle, desc);
    return (int)cudaGetLastError();
}
