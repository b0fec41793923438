// K1: FAST-9 score + 3x3 NMS + border inset + selection key + per-cell
// top-2, one pyramid level per launch.
//
// Replaces morb_slam_tpu/ops/fast.py:fast_score, nms3 and border_mask, with
// the key of morb_slam_tpu/frontend.py:_extract_level and the per-cell top_k
// stage of morb_slam_tpu/frontend.py:_select_level_keypoints. The per-level
// top-n_keep over the (ncells * 2) winners stays a stable sort in PyTorch.
//
// What bounds it on an H100: by the roofline, operations. The function reads
// each level image once (about 4.5 MB over 8 levels of a 752x480 frame,
// ~1.3 us at 3.35 TB/s) and writes 12 bytes per cell slot; its ~200 fp32
// min/max per pixel take ~3.4 us at 67 TFLOP/s. At these sizes launch and
// load latency set the time instead. The reference program materialises 16
// shifted copies of the level, the (H, W) score, NMS and key maps and a
// padded cell view in device memory; here only the results leave the SM.
//
// Design: one 256-thread block per 16x16 cell. The block stages a 24x24
// tile (3-px circle halo + 1-px NMS halo) in shared memory, wrapping at the
// image edge the way jnp.roll does, computes the 18x18 scores it needs into
// shared memory, then each thread forms the key of its pixel in registers.
// The in-cell top-2 is two block max-reductions over a 64-bit packing of
// (order-preserving key bits, 0xFFFF - in-cell index), so ties go to the
// lower in-cell index exactly as jax.lax.top_k orders them. Only the
// (ncells, 2) key / flat pixel index / raw score leave the chip.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define CELL 16
#define HALO 4
#define TILE (CELL + 2 * HALO)
#define STILE (CELL + 2)
#define NTHREADS (CELL * CELL)

__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int c_dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

__device__ __forceinline__ int wrap(int i, int n) {
    i %= n;
    return i < 0 ? i + n : i;
}

__device__ __forceinline__ unsigned int order_bits(float f) {
    unsigned int u = __float_as_uint(f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long block_max(unsigned long long v,
                                                        unsigned long long* red) {
    for (int off = 16; off > 0; off >>= 1) {
        unsigned long long o = __shfl_down_sync(0xffffffffu, v, off);
        v = o > v ? o : v;
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < NTHREADS / 32 ? red[lane] : 0ull;
        for (int off = 16; off > 0; off >>= 1) {
            unsigned long long o = __shfl_down_sync(0xffffffffu, v, off);
            v = o > v ? o : v;
        }
        if (lane == 0) red[0] = v;
    }
    __syncthreads();
    v = red[0];
    __syncthreads();
    return v;
}

__global__ void __launch_bounds__(NTHREADS)
fast_select_kernel(const float* __restrict__ img, int H, int W, float th_lo,
                   float th_hi, float boost, int border,
                   float* __restrict__ key_out, int* __restrict__ idx_out,
                   float* __restrict__ score_out) {
    __shared__ float tile[TILE][TILE];
    __shared__ float sc[STILE][STILE];
    __shared__ unsigned long long red[NTHREADS / 32];

    const int y0 = blockIdx.y * CELL, x0 = blockIdx.x * CELL;
    const int tid = threadIdx.x;

    for (int t = tid; t < TILE * TILE; t += NTHREADS) {
        const int ty = t / TILE, tx = t % TILE;
        const int gy = wrap(y0 - HALO + ty, H), gx = wrap(x0 - HALO + tx, W);
        tile[ty][tx] = img[(size_t)gy * W + gx];
    }
    __syncthreads();

    for (int s = tid; s < STILE * STILE; s += NTHREADS) {
        const int sy = s / STILE, sx = s % STILE;
        const int cy = sy + HALO - 1, cx = sx + HALO - 1;
        const float c = tile[cy][cx];
        float d[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) d[i] = tile[cy + c_dy[i]][cx + c_dx[i]] - c;
        float bright = -INFINITY, dark = -INFINITY;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            float mb = d[k], md = -d[k];
#pragma unroll
            for (int j = 1; j < 9; ++j) {
                mb = fminf(mb, d[(k + j) & 15]);
                md = fminf(md, -d[(k + j) & 15]);
            }
            bright = fmaxf(bright, mb);
            dark = fmaxf(dark, md);
        }
        sc[sy][sx] = fmaxf(bright, dark);
    }
    __syncthreads();

    const int ly = tid / CELL, lx = tid % CELL;
    const int y = y0 + ly, x = x0 + lx;
    const float s = sc[ly + 1][lx + 1];
    float neigh = -INFINITY;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
            if (dy == 0 && dx == 0) continue;
            const int ny = y + dy, nx = x + dx;
            if (ny >= 0 && ny < H && nx >= 0 && nx < W)
                neigh = fmaxf(neigh, sc[ly + 1 + dy][lx + 1 + dx]);
        }
    const bool inside = y >= border && y < H - border && x >= border && x < W - border;
    const bool weak = (s > th_lo) && (s >= neigh) && inside;
    const float key = weak ? s + (s > th_hi ? boost : 0.0f) : -INFINITY;

    const unsigned int cidx = (unsigned int)tid;
    const unsigned long long packed =
        ((unsigned long long)order_bits(key) << 32) | (0xFFFFu - cidx);
    const unsigned long long b1 = block_max(packed, red);
    const unsigned int c1 = 0xFFFFu - (unsigned int)(b1 & 0xFFFFull);
    const unsigned long long b2 = block_max(cidx == c1 ? 0ull : packed, red);
    const unsigned int c2 = 0xFFFFu - (unsigned int)(b2 & 0xFFFFull);

    const int cell = blockIdx.y * gridDim.x + blockIdx.x;
    const int slot = cidx == c1 ? 0 : (cidx == c2 ? 1 : -1);
    if (slot >= 0) {
        key_out[cell * 2 + slot] = key;
        idx_out[cell * 2 + slot] = y * W + x;
        score_out[cell * 2 + slot] = (y < H && x < W) ? s : 0.0f;
    }
}

extern "C" int fast_select(const float* img, int H, int W, float th_lo,
                           float th_hi, float boost, int border, float* key,
                           int* idx, float* score, void* stream) {
    dim3 grid((W + CELL - 1) / CELL, (H + CELL - 1) / CELL);
    fast_select_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        img, H, W, th_lo, th_hi, boost, border, key, idx, score);
    return (int)cudaGetLastError();
}
