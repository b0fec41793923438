// K2: intensity-centroid orientation + rotated BRIEF-256 of ORB keypoints,
// one warp per keypoint: `orb_describe` for the keypoints of one pyramid
// level, `orb_describe_levels` for every level of one image in one launch.
//
// Replaces morb_slam_tpu/ops/orb_descriptor.py:compute_orientations and
// compute_descriptors (called per level from
// morb_slam_tpu/frontend.py:_extract_level).
//
// What bounds it on an H100: neither bytes nor operations at these sizes.
// Per keypoint it reads 709 pixels of the raw level (the radius-15 disc)
// and 512 of the blurred level and writes 36 bytes; over the 1200 keypoints
// of a frame that is about 6 MB of mostly L2-resident reads (~1.8 us at
// 3.35 TB/s) and ~6 Mflop. What sets the time is each warp's chain of
// dependent memory round trips, and, per launch, the fill and drain of the
// grid: a level holds 72-261 of the 1200 keypoints, 9-33 blocks, so eight
// per-level launches leave most of the 132 SMs idle and pay eight tails.
//
// Design: one warp per keypoint. Lane u < 31 walks column u - 15 of the
// disc, issuing all 31 loads before it sums them (lanes of a row read
// neighbouring pixels); the two moments reduce by warp shuffles, then
// atan2f / sincosf give the rotation. The 256 pair tests run 8 per lane:
// each lane reads its 8 pattern pairs as int4 (coalesced; the pattern lives
// in global memory, uploaded once by orb_set_pattern), issues its 16 blurred
// gathers together, and __ballot_sync packs word w from test 32*w+lane;
// lanes 0-7 store the 8 words. Sample offsets round half to even
// (__float2int_rn), as jnp.round does, and the products are kept un-fused
// (__fmul_rn) so the rounding matches the plain version. Reflect padding
// (no edge repeat) is an index reflection. `orb_describe_levels` takes the
// levels as consecutive views of one buffer (as K6 builds them) and a table
// of each level's offset, shape, keypoint range and keypoint array in a
// by-value parameter; each warp finds its level from the keypoint ranges.
// Both entries run the same per-keypoint code, so they agree bitwise.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PATCH_R 15
#define WARPS_PER_BLOCK 8
#define MAX_LEVELS 16     // ops/image.py MAX_LEVELS
#define FULL 0xffffffffu

__device__ int4 g_pattern[256];

struct LevelTable {
    int n_levels;
    int off[MAX_LEVELS];        // element offset of each level in the buffers
    int h[MAX_LEVELS];
    int w[MAX_LEVELS];
    int kp0[MAX_LEVELS + 1];    // first keypoint of each level; kp0[n] total
    const int* yx[MAX_LEVELS];  // each level's (n, 2) keypoints
};

__device__ __forceinline__ int reflect(int i, int n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * (n - 1) - i;
    return i;
}

// Orientation and descriptor of the keypoint (y, x) on one level; every
// lane of the warp calls it. Lane 0 writes the angle, lanes 0-7 the words.
__device__ __forceinline__ void describe(const float* __restrict__ img,
                                         const float* __restrict__ blur,
                                         int H, int W, int y, int x, int lane,
                                         float* __restrict__ angle_out,
                                         int* __restrict__ desc_out) {
    // the pattern pairs first: they do not depend on the angle
    int4 pat[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) pat[w] = g_pattern[32 * w + lane];

    float m10 = 0.0f, m01 = 0.0f;
    if (lane < 2 * PATCH_R + 1) {
        const int u = lane - PATCH_R;
        const int gx = reflect(x + u, W);
        float p[2 * PATCH_R + 1];
#pragma unroll
        for (int v = -PATCH_R; v <= PATCH_R; ++v)
            p[v + PATCH_R] = u * u + v * v <= PATCH_R * PATCH_R
                ? img[(size_t)reflect(y + v, H) * W + gx] : 0.0f;
#pragma unroll
        for (int v = -PATCH_R; v <= PATCH_R; ++v) {
            if (u * u + v * v <= PATCH_R * PATCH_R) {
                m10 += (float)u * p[v + PATCH_R];
                m01 += (float)v * p[v + PATCH_R];
            }
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        m10 += __shfl_xor_sync(FULL, m10, off);
        m01 += __shfl_xor_sync(FULL, m01, off);
    }
    const float ang = atan2f(m01, m10);
    float sa, ca;
    sincosf(ang, &sa, &ca);

    float a[8], b[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
        const float px1 = (float)pat[w].x, py1 = (float)pat[w].y;
        const float px2 = (float)pat[w].z, py2 = (float)pat[w].w;
        const int x1 = __float2int_rn(__fsub_rn(__fmul_rn(px1, ca), __fmul_rn(py1, sa)));
        const int y1 = __float2int_rn(__fadd_rn(__fmul_rn(px1, sa), __fmul_rn(py1, ca)));
        const int x2 = __float2int_rn(__fsub_rn(__fmul_rn(px2, ca), __fmul_rn(py2, sa)));
        const int y2 = __float2int_rn(__fadd_rn(__fmul_rn(px2, sa), __fmul_rn(py2, ca)));
        a[w] = blur[(size_t)reflect(y + y1, H) * W + reflect(x + x1, W)];
        b[w] = blur[(size_t)reflect(y + y2, H) * W + reflect(x + x2, W)];
    }
    unsigned mine = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
        const unsigned bits = __ballot_sync(FULL, a[w] < b[w]);
        if (lane == w) mine = bits;
    }
    if (lane < 8) desc_out[lane] = (int)mine;
    if (lane == 0) *angle_out = ang;
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
orb_describe_kernel(const float* __restrict__ img, const float* __restrict__ blur,
                    int H, int W, const int* __restrict__ yx, int n,
                    float* __restrict__ angle_out, int* __restrict__ desc_out) {
    const int k = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (k >= n) return;  // the whole warp leaves together
    describe(img, blur, H, W, yx[2 * k], yx[2 * k + 1], lane, angle_out + k,
             desc_out + 8 * (size_t)k);
}

__global__ void __launch_bounds__(WARPS_PER_BLOCK * 32)
orb_describe_levels_kernel(const float* __restrict__ img,
                           const float* __restrict__ blur,
                           const LevelTable lv,
                           float* __restrict__ angle_out,
                           int* __restrict__ desc_out) {
    const int k = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (k >= lv.kp0[lv.n_levels]) return;  // the whole warp leaves together
    int l = 0;                              // empty levels are skipped over
    while (l + 1 < lv.n_levels && lv.kp0[l + 1] <= k) ++l;
    const int* yx = lv.yx[l] + 2 * (k - lv.kp0[l]);
    describe(img + lv.off[l], blur + lv.off[l], lv.h[l], lv.w[l], yx[0],
             yx[1], lane, angle_out + k, desc_out + 8 * (size_t)k);
}

extern "C" int orb_set_pattern(const int* host_pattern) {
    cudaMemcpyToSymbol(g_pattern, host_pattern, sizeof(int) * 256 * 4);
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

// n_levels levels at element offsets `off` of img / blur, of shapes (h, w),
// with counts[l] keypoints at yx[l]; outputs in level order.
extern "C" int orb_describe_levels(const float* img, const float* blur,
                                   int n_levels, const int* off,
                                   const int* h, const int* w,
                                   const int* counts, const int* const* yx,
                                   float* angle, int* desc, void* stream) {
    if (n_levels < 1 || n_levels > MAX_LEVELS) return -1;
    LevelTable lv;
    lv.n_levels = n_levels;
    lv.kp0[0] = 0;
    for (int l = 0; l < n_levels; ++l) {
        lv.off[l] = off[l];
        lv.h[l] = h[l];
        lv.w[l] = w[l];
        lv.yx[l] = yx[l];
        lv.kp0[l + 1] = lv.kp0[l] + counts[l];
    }
    const int n = lv.kp0[n_levels];
    if (n == 0) return 0;
    const int blocks = (n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
    orb_describe_levels_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0,
                                 (cudaStream_t)stream>>>(img, blur, lv, angle,
                                                          desc);
    return (int)cudaGetLastError();
}
