// K6: the ORB image pyramid (antialiased 1/scale downscale, level by level)
// and the 7x7 sigma = 2 Gaussian blur of every level.
//
// Replaces morb_slam_tpu/ops/image.py:build_pyramid (the jax.image.resize
// "linear" chain, antialiased on downscale) and :gaussian_blur (separable,
// edge-replicated), which morb_slam_tpu/frontend.py:extract_orb runs on
// every image of every frame before FAST (K1) and BRIEF (K2).
//
// What bounds it on an H100: bytes. One 752x480 image in, levels 1-7 and
// eight blurred levels out: ~2.6 MB in and ~6.3 MB out per image (2.7 us
// at 3.35 TB/s), against ~20 Mflop. At these sizes a launch costs more
// than its data, so the design keeps launches few: one per pyramid level
// and one for the blur of all levels.
//
// Pyramid (pyramid_level): the triangle filter of resize_weights is
// separable and banded: each output row (column) reads a run of at most a
// few consecutive input rows (columns). The wrapper extracts each band once
// per shape as (start, count) and count weights, in ascending input
// order. A block makes a TY x TX output tile: pass 1 filters the input
// rows into a shared-memory tile of TY rows and the tile's input columns
// (rows first, as the plain W_h^T @ img @ W_w associates), pass 2 filters
// those columns. Each band is summed in ascending input order in float32,
// so the result is repeatable bit for bit; cuBLAS sums the dense plain
// product in another order, so kernel and plain agree to a tolerance.
//
// Blur (blur_levels): all levels of one buffer in one launch; a block
// finds its level from the per-level tile offsets and blurs a TY x TX tile
// from a shared-memory copy with a 3-pixel edge-replicated halo, rows then
// columns. The arithmetic is the plain version's, step for step (out = 0;
// out = out + k[i] * p[i], i = 0..6) with __fmul_rn / __fadd_rn, so no FMA
// contraction changes the rounding and the blur is bitwise equal to the
// plain blur. No atomics anywhere.
#include <cuda_runtime.h>

#define TX 32
#define TY 8
#define CX 64          // pyramid: input columns a tile may span
#define MAX_TAPS 8     // pyramid: taps of one band
#define MAX_LEVELS 16
#define R 3            // blur radius

struct Kernel7 {
    float k[7];
};

struct LevelTable {
    int n;                   // levels
    int off[MAX_LEVELS];     // element offset of each level in the buffers
    int h[MAX_LEVELS];
    int w[MAX_LEVELS];
    int tiles_x[MAX_LEVELS];
    int tile0[MAX_LEVELS + 1];  // first block of each level; tile0[n] total
};

// Band tables of one level: rows (length h_out) then columns (w_out):
// start, count, and MAX_TAPS weights per output.
__global__ void __launch_bounds__(TX * TY)
pyramid_level_kernel(const float* __restrict__ src, int h_in, int w_in,
                     float* __restrict__ dst, int h_out, int w_out,
                     const int* __restrict__ r_start,
                     const int* __restrict__ r_count,
                     const float* __restrict__ r_w,
                     const int* __restrict__ c_start,
                     const int* __restrict__ c_count,
                     const float* __restrict__ c_w) {
    __shared__ float tmp[TY][CX];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int ox0 = blockIdx.x * TX, oy = blockIdx.y * TY + ty;
    const int col0 = c_start[ox0];
    // pass 1: the tile's rows, filtered over input rows, at the input
    // columns col0 .. col0 + CX - 1
    if (oy < h_out) {
        const int rs = r_start[oy], rc = r_count[oy];
        for (int c = tx; c < CX; c += TX) {
            const int col = col0 + c;
            if (col >= w_in) break;
            float acc = 0.0f;
            for (int t = 0; t < rc; t++)
                acc = __fadd_rn(acc, __fmul_rn(r_w[oy * MAX_TAPS + t],
                                               __ldg(src + (size_t)(rs + t)
                                                     * w_in + col)));
            tmp[ty][c] = acc;
        }
    }
    __syncthreads();
    // pass 2: filter the tile's columns
    const int ox = ox0 + tx;
    if (oy >= h_out || ox >= w_out) return;
    const int cs = c_start[ox] - col0, cc = c_count[ox];
    float acc = 0.0f;
    for (int t = 0; t < cc; t++)
        acc = __fadd_rn(acc, __fmul_rn(c_w[ox * MAX_TAPS + t],
                                       tmp[ty][cs + t]));
    dst[(size_t)oy * w_out + ox] = acc;
}

__global__ void __launch_bounds__(TX * TY)
blur_levels_kernel(const float* __restrict__ src, float* __restrict__ dst,
                   LevelTable lv, Kernel7 k) {
    __shared__ float in[TY + 2 * R][TX + 2 * R];
    __shared__ float mid[TY][TX + 2 * R];
    int l = 0;
    while (l + 1 < lv.n && (int)blockIdx.x >= lv.tile0[l + 1]) l++;
    const int tile = blockIdx.x - lv.tile0[l];
    const int h = lv.h[l], w = lv.w[l];
    const int x0 = (tile % lv.tiles_x[l]) * TX, y0 = (tile / lv.tiles_x[l]) * TY;
    const float* s = src + lv.off[l];
    const int tid = threadIdx.y * TX + threadIdx.x;
    // the tile and its halo, edge-replicated (the plain version's padding)
    for (int i = tid; i < (TY + 2 * R) * (TX + 2 * R); i += TX * TY) {
        const int r = i / (TX + 2 * R), c = i % (TX + 2 * R);
        const int y = min(max(y0 + r - R, 0), h - 1);
        const int x = min(max(x0 + c - R, 0), w - 1);
        in[r][c] = __ldg(s + (size_t)y * w + x);
    }
    __syncthreads();
    // rows: the vertical pass at every column of the tile and its halo
    for (int i = tid; i < TY * (TX + 2 * R); i += TX * TY) {
        const int r = i / (TX + 2 * R), c = i % (TX + 2 * R);
        float acc = 0.0f;
        for (int t = 0; t < 7; t++)
            acc = __fadd_rn(acc, __fmul_rn(k.k[t], in[r + t][c]));
        mid[r][c] = acc;
    }
    __syncthreads();
    const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
    if (x >= w || y >= h) return;
    float acc = 0.0f;
    for (int t = 0; t < 7; t++)
        acc = __fadd_rn(acc, __fmul_rn(k.k[t], mid[threadIdx.y][threadIdx.x
                                                               + t]));
    dst[lv.off[l] + (size_t)y * w + x] = acc;
}

extern "C" int pyramid_level(const void* src, int h_in, int w_in, void* dst,
                             int h_out, int w_out, const void* bands,
                             void* stream) {
    // bands: int32 r_start[h_out], r_count[h_out], c_start[w_out],
    // c_count[w_out], then float32 r_w[h_out * MAX_TAPS],
    // c_w[w_out * MAX_TAPS]
    const int* b = (const int*)bands;
    const int* r_start = b;
    const int* r_count = b + h_out;
    const int* c_start = b + 2 * h_out;
    const int* c_count = b + 2 * h_out + w_out;
    const float* r_w = (const float*)(b + 2 * h_out + 2 * w_out);
    const float* c_w = r_w + (size_t)h_out * MAX_TAPS;
    const dim3 grid((w_out + TX - 1) / TX, (h_out + TY - 1) / TY);
    pyramid_level_kernel<<<grid, dim3(TX, TY), 0, (cudaStream_t)stream>>>(
        (const float*)src, h_in, w_in, (float*)dst, h_out, w_out, r_start,
        r_count, r_w, c_start, c_count, c_w);
    return (int)cudaGetLastError();
}

extern "C" int blur_levels(const void* src, void* dst, int n_levels,
                           const int* off, const int* h, const int* w,
                           const float* kernel7, void* stream) {
    if (n_levels < 1 || n_levels > MAX_LEVELS) return -1;
    LevelTable lv;
    lv.n = n_levels;
    lv.tile0[0] = 0;
    for (int l = 0; l < n_levels; l++) {
        lv.off[l] = off[l];
        lv.h[l] = h[l];
        lv.w[l] = w[l];
        lv.tiles_x[l] = (w[l] + TX - 1) / TX;
        lv.tile0[l + 1] = lv.tile0[l] + lv.tiles_x[l] * ((h[l] + TY - 1) / TY);
    }
    Kernel7 k;
    for (int i = 0; i < 7; i++) k.k[i] = kernel7[i];
    if (lv.tile0[n_levels] == 0) return 0;
    blur_levels_kernel<<<lv.tile0[n_levels], dim3(TX, TY), 0,
                         (cudaStream_t)stream>>>((const float*)src,
                                                 (float*)dst, lv, k);
    return (int)cudaGetLastError();
}
