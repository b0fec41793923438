// K8: bilinear remap with a zero border, a batch of images in one launch.
//
// Replaces morb_slam_tpu/ops/rectify.py:remap_bilinear, which the stereo
// front end (morb_slam_tpu/system.py:System.track_stereo) calls on both
// images of every raw stereo pair to rectify them.
//
// What bounds it on an H100: bytes. Per output pixel it reads one (x, y)
// float2 from the map (8 B), four source taps (at most 16 B, mostly cache
// hits: neighbouring outputs share taps) and writes 4 B; about 20 flops.
// At 752 x 480 x 2 images that is ~11 MB, ~3.4 us at 3.35 TB/s, against
// ~14 Mflop, far below the card's float rate.
//
// Design: one thread per output pixel, consecutive threads on consecutive
// pixels of a row so the map reads and the output writes coalesce; the
// source taps go through the read-only cache. blockIdx.y picks the image of
// the batch. The arithmetic reproduces the plain version's rounding: floor,
// the clamped x1 / y1 at the last column and row, the `inside` test, and
// the four products summed in the reference's order with no contraction to
// FMA (__fmul_rn / __fadd_rn), so kernel and plain version agree bitwise.
#include <cuda_runtime.h>

#define THREADS 256

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(THREADS)
remap_bilinear_kernel(const float* __restrict__ img, int Hs, int Ws,
                      const float2* __restrict__ map, int H, int W,
                      float* __restrict__ out) {
    const size_t n = (size_t)H * W;
    const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    const size_t b = blockIdx.y;
    const float* src = img + b * (size_t)Hs * Ws;
    const float2 m = map[b * n + i];
    const float x = m.x, y = m.y;
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = __fsub_rn(x, x0), fy = __fsub_rn(y, y0);
    // float -> int saturates on the card; any coordinate where that
    // matters lies outside the image and is zeroed below
    const int x0i = clampi(__float2int_rz(x0), 0, Ws - 1);
    const int y0i = clampi(__float2int_rz(y0), 0, Hs - 1);
    const int x1i = clampi(x0i + 1, 0, Ws - 1);
    const int y1i = clampi(y0i + 1, 0, Hs - 1);
    const float v00 = __ldg(src + (size_t)y0i * Ws + x0i);
    const float v01 = __ldg(src + (size_t)y0i * Ws + x1i);
    const float v10 = __ldg(src + (size_t)y1i * Ws + x0i);
    const float v11 = __ldg(src + (size_t)y1i * Ws + x1i);
    const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
    float acc = __fmul_rn(__fmul_rn(v00, gx), gy);
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v01, fx), gy));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v10, gx), fy));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v11, fx), fy));
    const bool inside = (x >= 0.0f) && (x <= (float)(Ws - 1)) &&
                        (y >= 0.0f) && (y <= (float)(Hs - 1));
    out[b * n + i] = inside ? acc : 0.0f;
}

extern "C" int remap_bilinear(const void* img, int Hs, int Ws,
                              const void* map, int H, int W, int B, void* out,
                              void* stream) {
    const size_t n = (size_t)H * W;
    if (n == 0 || B == 0) return 0;
    const dim3 grid((unsigned)((n + THREADS - 1) / THREADS), (unsigned)B);
    remap_bilinear_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)img, Hs, Ws, (const float2*)map, H, W, (float*)out);
    return (int)cudaGetLastError();
}
