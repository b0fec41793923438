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
// than its data, so the path makes one launch an image (pyramid_blur).
//
// Pyramid: the triangle filter of resize_weights is separable and banded:
// each output row (column) reads a run of at most a few consecutive input
// rows (columns). The wrapper extracts each band once per shape as (start,
// count) and count weights, in ascending input order. A tile's pass 1
// filters the input rows into shared memory at the tile's input columns
// (rows first, as the plain W_h^T @ img @ W_w associates), pass 2 filters
// those columns. Each band is summed in ascending input order in float32,
// so the result is repeatable bit for bit; cuBLAS sums the dense plain
// product in another order, so kernel and plain agree to a tolerance.
//
// Blur: a TY x TX tile from a shared-memory copy with a 3-pixel
// edge-replicated halo, rows then columns. The arithmetic is the plain
// version's, step for step (out = 0; out = out + k[i] * p[i], i = 0..6)
// with __fmul_rn / __fadd_rn, so no FMA contraction changes the rounding
// and the blur is bitwise equal to the plain blur. No atomics anywhere.
//
// One launch an image (pyramid_blur_kernel): a cooperative launch of as
// many blocks as are co-resident, in phases p = 1..n with a grid barrier
// between them, since level p is made from the whole of level p - 1.
// Phase p makes level p's FTY x FTX tiles (p < n) and blurs tiles of the
// levels already complete (< p), so the blurs fill the blocks the shrinking
// levels leave idle and only the last level's blur waits for a phase of
// its own; the host assigns each phase its run of blur tiles (bstart). A
// pyramid tile loads its rows' and columns' bands, then its input window
// from its first bands, every load of a batch in flight at once, then
// filters from shared memory. A blur tile of level 0 reads the image and
// also writes it as level 0 (the copy). Levels written in this launch are
// read through L2 (__ldcg), never the read-only cache. Every value repeats
// the per-level path's operations (pyramid_level_kernel,
// blur_levels_kernel, kept as its comparison), so the two are bitwise
// equal.
#include <cooperative_groups.h>
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

// ---------------------------------------------------------------------------
// one launch an image
// ---------------------------------------------------------------------------

#define FTX 32
#define FTY 16
#define FCX 64                 // input columns a pyramid tile reads
#define FRX 32                 // input rows a pyramid tile reads
#define FCOLS (FTX + 2 * R)
#define FROWS (FTY + 2 * R)
#define FTHREADS 256
#define FMIN_BLOCKS 4          // co-resident blocks a multiprocessor

// mirrored by ops/image.py:_PyrBlurTable
struct PyrBlurTable {
    int n;
    int off[MAX_LEVELS];       // element offset of each level in the buffers
    int h[MAX_LEVELS];
    int w[MAX_LEVELS];
    int tiles_x[MAX_LEVELS];
    int tiles[MAX_LEVELS];
    int band[MAX_LEVELS];      // int32 offset of level l's bands (l >= 1)
    int span[MAX_LEVELS];      // input columns a tile reads (<= FCX)
    int rspan[MAX_LEVELS];     // input rows a tile reads (<= FRX)
    int btile0[MAX_LEVELS + 1];  // first blur tile of each level (all levels)
    int bstart[MAX_LEVELS + 2];  // phase p blurs tiles bstart[p] .. [p + 1]
    float k[7];
};

struct FusedSmem {
    int rs[FTY], rc[FTY], cs[FTX], cc[FTX];
    float rw[FTY][MAX_TAPS], cw[MAX_TAPS][FTX];   // cw by tap: no conflicts
    float stage[FRX][FCX];
    float tmp[FTY][FCX];
    float in[FROWS][FCOLS];
    float mid[FTY][FCOLS];
};

// level l >= 1, tile (x0, y0): the band sums of pyramid_level_kernel
__device__ void pyramid_tile(const PyrBlurTable& t, const int* bands,
                             const float* src, float* dst, int l, int x0,
                             int y0, FusedSmem& sm) {
    const int tid = threadIdx.x;
    const int h = t.h[l], w = t.w[l], h_in = t.h[l - 1], w_in = t.w[l - 1];
    const int* r_start = bands + t.band[l];
    const int* r_count = r_start + h;
    const int* c_start = r_count + h;
    const int* c_count = c_start + w;
    const float* r_w = (const float*)(c_count + w);
    const float* c_w = r_w + (size_t)h * MAX_TAPS;
    const int ny = min(FTY, h - y0), nx = min(FTX, w - x0);
    // the tile's bands: 480 values, a thread's loads in flight at once
    const int NB = (FTY + FTX) * (2 + MAX_TAPS);
    const int KB = (NB + FTHREADS - 1) / FTHREADS;
    const int* from[KB];
    int* to[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k) {
        const int i = tid + k * FTHREADS;
        from[k] = nullptr;
        to[k] = nullptr;
        if (i < FTY * 2) {
            const int r = i >> 1;
            if (r < ny) {
                from[k] = (i & 1 ? r_count : r_start) + y0 + r;
                to[k] = (i & 1 ? sm.rc : sm.rs) + r;
            }
        } else if (i < FTY * 2 + FTX * 2) {
            const int c = (i - FTY * 2) >> 1;
            if (c < nx) {
                from[k] = (i & 1 ? c_count : c_start) + x0 + c;
                to[k] = (i & 1 ? sm.cc : sm.cs) + c;
            }
        } else if (i < FTY * (2 + MAX_TAPS) + FTX * 2) {
            const int j = i - FTY * 2 - FTX * 2, r = j / MAX_TAPS;
            if (r < ny) {
                from[k] = (const int*)r_w + (size_t)(y0 + r) * MAX_TAPS
                          + j % MAX_TAPS;
                to[k] = (int*)&sm.rw[r][j % MAX_TAPS];
            }
        } else if (i < NB) {
            const int j = i - FTY * (2 + MAX_TAPS) - FTX * 2, c = j / MAX_TAPS;
            if (c < nx) {
                from[k] = (const int*)c_w + (size_t)(x0 + c) * MAX_TAPS
                          + j % MAX_TAPS;
                to[k] = (int*)&sm.cw[j % MAX_TAPS][c];
            }
        }
    }
    int got[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k) got[k] = from[k] ? __ldg(from[k]) : 0;
#pragma unroll
    for (int k = 0; k < KB; ++k)
        if (to[k]) *to[k] = got[k];
    __syncthreads();
    // the input window from the tile's first bands, FRX x FCX at most,
    // every load in flight at once
    const int row0 = sm.rs[0], col0 = sm.cs[0];
    const int nrow = min(t.rspan[l], h_in - row0);
    const int ncol = min(t.span[l], w_in - col0);
    float v[FRX * FCX / FTHREADS];
#pragma unroll
    for (int k = 0; k < FRX * FCX / FTHREADS; ++k) {
        const int i = tid + k * FTHREADS, r = i / FCX, c = i % FCX;
        v[k] = r < nrow && c < ncol
            ? __ldcg(src + (size_t)(row0 + r) * w_in + col0 + c) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < FRX * FCX / FTHREADS; ++k) {
        const int i = tid + k * FTHREADS;
        sm.stage[i / FCX][i % FCX] = v[k];
    }
    __syncthreads();
    // pass 1: the tile's rows over input rows, at the window's columns
    for (int i = tid; i < ny * FCX; i += FTHREADS) {
        const int r = i / FCX, c = i % FCX;
        if (c >= ncol) continue;
        const int rs = sm.rs[r] - row0, rc = sm.rc[r];
        float acc = 0.0f;
        for (int q = 0; q < rc; q++)
            acc = __fadd_rn(acc, __fmul_rn(sm.rw[r][q], sm.stage[rs + q][c]));
        sm.tmp[r][c] = acc;
    }
    __syncthreads();
    // pass 2: the tile's columns
    for (int i = tid; i < ny * FTX; i += FTHREADS) {
        const int r = i / FTX, c = i % FTX;
        if (c >= nx) continue;
        const int cs = sm.cs[c] - col0, cc = sm.cc[c];
        float acc = 0.0f;
        for (int q = 0; q < cc; q++)
            acc = __fadd_rn(acc, __fmul_rn(sm.cw[q][c], sm.tmp[r][cs + q]));
        dst[(size_t)(y0 + r) * w + x0 + c] = acc;
    }
}

// level l, tile (x0, y0): the arithmetic of blur_levels_kernel; level 0
// reads the image and writes it as level 0 too
__device__ void blur_tile(const PyrBlurTable& t, const float* img,
                          float* levels, float* blurred, int l, int x0,
                          int y0, FusedSmem& sm) {
    const int tid = threadIdx.x;
    const int h = t.h[l], w = t.w[l];
    const float* s = l ? levels + t.off[l] : img;
    const int N = FROWS * FCOLS, K = (N + FTHREADS - 1) / FTHREADS;
    float v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int i = tid + k * FTHREADS, r = i / FCOLS, c = i % FCOLS;
        const int y = min(max(y0 + r - R, 0), h - 1);
        const int x = min(max(x0 + c - R, 0), w - 1);
        v[k] = i >= N ? 0.0f : l ? __ldcg(s + (size_t)y * w + x)
                                 : __ldg(s + (size_t)y * w + x);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int i = tid + k * FTHREADS;
        if (i < N) sm.in[i / FCOLS][i % FCOLS] = v[k];
    }
    __syncthreads();
    for (int i = tid; i < FTY * FCOLS; i += FTHREADS) {
        const int r = i / FCOLS, c = i % FCOLS;
        float acc = 0.0f;
        for (int q = 0; q < 7; q++)
            acc = __fadd_rn(acc, __fmul_rn(t.k[q], sm.in[r + q][c]));
        sm.mid[r][c] = acc;
    }
    __syncthreads();
    for (int i = tid; i < FTY * FTX; i += FTHREADS) {
        const int r = i / FTX, c = i % FTX, y = y0 + r, x = x0 + c;
        if (y >= h || x >= w) continue;
        float acc = 0.0f;
        for (int q = 0; q < 7; q++)
            acc = __fadd_rn(acc, __fmul_rn(t.k[q], sm.mid[r][c + q]));
        blurred[t.off[l] + (size_t)y * w + x] = acc;
        if (l == 0) levels[(size_t)y * w + x] = sm.in[r + R][c + R];
    }
}

__global__ void __launch_bounds__(FTHREADS, FMIN_BLOCKS)
pyramid_blur_kernel(const float* __restrict__ img, float* levels,
                    float* __restrict__ blurred,
                    const int* __restrict__ bands, PyrBlurTable t) {
    __shared__ FusedSmem sm;
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    for (int p = 1; p <= t.n; ++p) {
        if (p > 1) grid.sync();
        const int n_pyr = p < t.n ? t.tiles[p] : 0;
        const int n_items = n_pyr + t.bstart[p + 1] - t.bstart[p];
        for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
            __syncthreads();        // the previous item's shared memory
            if (it < n_pyr) {
                const float* src = p > 1 ? levels + t.off[p - 1] : img;
                pyramid_tile(t, bands, src, levels + t.off[p], p,
                             (it % t.tiles_x[p]) * FTX,
                             (it / t.tiles_x[p]) * FTY, sm);
            } else {
                const int b = t.bstart[p] + it - n_pyr;
                int l = 0;
                while (b >= t.btile0[l + 1]) l++;
                const int tile = b - t.btile0[l];
                blur_tile(t, img, levels, blurred, l,
                          (tile % t.tiles_x[l]) * FTX,
                          (tile / t.tiles_x[l]) * FTY, sm);
            }
        }
    }
}

// img: (h[0], w[0]) float32; levels, blurred: the level buffers (t->off);
// bands: int32 blob of the band tables of levels 1.. (t->band). Fills
// bstart for the grid it launches.
extern "C" int pyramid_blur(const void* img, void* levels, void* blurred,
                            const void* bands, const void* table,
                            void* stream) {
    const PyrBlurTable* tp = (const PyrBlurTable*)table;
    const int n = tp->n;
    if (n < 1 || n > MAX_LEVELS) return -1;
    for (int l = 1; l < n; ++l)
        if (tp->span[l] > FCX || tp->rspan[l] > FRX) return -1;
    // blocks that are co-resident on the card, once per device
    static int max_grid[64];
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 64) return -1;
    if (max_grid[dev] == 0) {
        int per_sm = 0, sms = 0;
        cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, pyramid_blur_kernel, FTHREADS, 0);
        if (e != cudaSuccess) return (int)e;
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return (int)e;
        max_grid[dev] = per_sm * sms;
    }
    const int grid = max_grid[dev];
    if (grid < 1) return -1;
    // phase p blurs the next tiles of the levels below p that fit beside
    // its pyramid tiles in one round of the grid; the last phase the rest
    PyrBlurTable t = *tp;
    t.bstart[1] = 0;
    for (int p = 1; p <= n; ++p) {
        const int room = p < n ? grid - t.tiles[p] : t.btile0[n];
        int end = t.bstart[p] + (room > 0 ? room : 0);
        if (end > t.btile0[p] || p == n) end = t.btile0[p];
        t.bstart[p + 1] = end;
    }
    const float* ip = (const float*)img;
    float* lp = (float*)levels;
    float* bp = (float*)blurred;
    const int* band = (const int*)bands;
    void* args[] = {(void*)&ip, (void*)&lp, (void*)&bp, (void*)&band,
                    (void*)&t};
    return (int)cudaLaunchCooperativeKernel((const void*)pyramid_blur_kernel,
                                            dim3(grid), dim3(FTHREADS), args,
                                            0, (cudaStream_t)stream);
}
