// K1: FAST-9 score + 3x3 NMS + border inset + selection key + per-cell
// top-2, and each level's top n_keep of those, for every level of an image
// in two launches.
//
// Replaces morb_slam_tpu/ops/fast.py:fast_score, nms3 and border_mask, with
// the key of morb_slam_tpu/frontend.py:_extract_level, the whole of
// morb_slam_tpu/frontend.py:_select_level_keypoints (the per-cell top_k and
// the level's top_k) and extract_orb's per-level slots (uv, octave, size).
//
// What bounds it on an H100: by the roofline, the bytes, unless most pixels
// pass FAST's compass test. The function reads each level image once (about
// 4.5 MB over 8 levels of a 752x480 frame, ~1.3 us at 3.35 TB/s) and writes
// 33 bytes a kept keypoint. Every pixel needs the compass test (4
// differences, 8 compares), NMS (8 maxima) and its key (~4): 24 fp32
// operations. Only a pixel that passes the test needs its score: 12 more
// differences and 2 x 57 for the runs of 9 and their reduction (the van Herk
// form below), 128 more. Scoring every pixel would take ~2.4 us at 67
// TFLOP/s; how many pass depends on the image (chip_smoke.py counts them
// for its bound). The reference program materialises 16 shifted copies of
// each level, the score, NMS and key maps and a padded cell view, and sorts
// each level's cell winners, in device memory; here only the cell winners
// (12 bytes a slot) and the kept keypoints leave the SM.
//
// Design. The levels are consecutive views of one buffer (K6's
// build_pyramid); a table gives each level's offset, shape and first cell.
//  - Cell stage: one 128-thread block per 16x16 cell of every level, one
//    launch. The block stages a 24x24 tile (3-px circle halo + 1-px NMS
//    halo) in shared memory, wrapping at the image edge the way jnp.roll
//    does (the `%` only in blocks that touch the edge). Of the 18x18
//    positions whose scores the cell needs, only those that pass FAST's
//    compass test are scored, compacted so that whole warps score them;
//    the runs of 9 go by prefix and suffix extremes (42 min a polarity
//    where the doubling form takes 64, the dark one as a max). Min and max
//    are exact in any order, so the scores equal the plain version's
//    bitwise. Each thread then keys two pixels. The in-cell top-2 is a warp
//    top-2 by shuffles over a 64-bit packing of (order-preserving key bits,
//    0xFFFF - in-cell index), then one merge of the 4 warps' pairs: ties go
//    to the lower in-cell index exactly as jax.lax.top_k orders them.
//  - Level stage: one 1024-thread block per level keeps the best min(n_keep,
//    2 x ncells) of the level's cell winners by a radix select over the
//    keys' order bits, then orders them by rank over 64-bit keys
//    (order_bits(key) << 32 | ~slot): the order of torch.sort(
//    descending=True, stable=True) over the keys and of jax.lax.top_k. It
//    writes each kept slot's (y, x) (0 where the key is -inf), key, raw
//    score, valid, uv = (x, y) * float32(scale^l), octave and size. A
//    level too large for the block's shared memory (above ~28k cells on an
//    H100) reads its keys from global memory in each pass and compacts its
//    kept slots into a global scratch buffer instead: a second instance of
//    the kernel, launched only when some level needs it. (A bitonic sort of all the winners spent 39 us on level 0's 4,096 keys
//    on an H100: 78 passes over shared memory, each bound by its
//    bandwidth.)
// The cell stage also runs alone on one level (fast_select), the per-level
// entry point that the tests hold against the plain version.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define CELL 16
#define HALO 4
#define TILE (CELL + 2 * HALO)
#define STILE (CELL + 2)
#define TS 50                   // tile row stride: 18 + 32, so the 18 x 18 score
                                // positions of a warp's lanes fall in distinct banks
#define CT 128                  // threads of a cell block
#define CW (CT / 32)            // warps of a cell block
#define MAX_LEVELS 16
#define ST 1024                 // threads of a level block

#define CELL_MIN_BLOCKS 12      // cell blocks an SM keeps resident (<= 40 registers)

struct LevelTable {
    int n_levels;
    int off[MAX_LEVELS];            // element offset of each level in the buffer
    int h[MAX_LEVELS];
    int w[MAX_LEVELS];
    int ncx[MAX_LEVELS];            // cells across
    int cell0[MAX_LEVELS + 1];      // first cell of each level; cell0[n] total
    int keep[MAX_LEVELS];           // slots kept (0: the level has no cells)
    int out0[MAX_LEVELS];           // first output slot of each level
    int big[MAX_LEVELS];            // 1: the level's selection works in global
                                    // memory (too many slots for shared)
    float scale[MAX_LEVELS];        // float32(scale ** l)
    float size[MAX_LEVELS];         // float32(31 * scale ** l)
};

__device__ __forceinline__ int wrap(int i, int n) {
    i %= n;
    return i < 0 ? i + n : i;
}

__device__ __forceinline__ unsigned int order_bits(float f) {
    unsigned int u = __float_as_uint(f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(unsigned int u) {
    return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

// (best, second) of two pairs; packed values are distinct.
__device__ __forceinline__ void merge_top2(unsigned long long& b,
                                           unsigned long long& s,
                                           unsigned long long ob,
                                           unsigned long long os) {
    const unsigned long long lo = b < ob ? b : ob;
    const unsigned long long so = s > os ? s : os;
    b = b > ob ? b : ob;
    s = lo > so ? lo : so;
}

// The minimum (MAX = false) or maximum (MAX = true) of each run of 9
// consecutive circle values, reduced by the maximum (bright) or minimum
// (dark) over the 16 runs. Runs by van Herk / Gil-Werman over the circle
// unrolled to e[0..23] = d[i mod 16], cut in blocks [0, 8], [9, 17],
// [18, 23]: a run starting at k in 1..8 is a suffix of block 0 and a prefix
// of block 1, one at 10..15 a suffix of block 1 and a prefix of block 2,
// runs 0 and 9 are whole blocks: 42 min (max) a polarity where the doubling
// form of fast.py:_run9_min takes 64. Min and max are exact, so the result
// equals the plain version's bitwise.
template <bool MAX>
__device__ __forceinline__ float run9_extreme(const float* d) {
    auto f = [](float a, float b) { return MAX ? fmaxf(a, b) : fminf(a, b); };
    auto g = [](float a, float b) { return MAX ? fminf(a, b) : fmaxf(a, b); };
    float s0[9], p1[17], s1[18], p2[24];
    s0[8] = d[8];
#pragma unroll
    for (int k = 7; k >= 0; --k) s0[k] = f(d[k], s0[k + 1]);
    p1[9] = d[9];
#pragma unroll
    for (int j = 10; j <= 16; ++j) p1[j] = f(p1[j - 1], d[j & 15]);
    s1[17] = d[1];
#pragma unroll
    for (int k = 16; k >= 9; --k) s1[k] = f(d[k & 15], s1[k + 1]);
    p2[18] = d[2];
#pragma unroll
    for (int j = 19; j <= 23; ++j) p2[j] = f(p2[j - 1], d[j & 15]);
    float r = g(s0[0], s1[9]);
#pragma unroll
    for (int k = 1; k <= 8; ++k) r = g(r, f(s0[k], p1[k + 8]));
#pragma unroll
    for (int k = 10; k <= 15; ++k) r = g(r, f(s1[k], p2[k + 8]));
    return r;
}

// The FAST score of the tile pixel at p: the largest threshold at which it
// is a corner, bright (the largest run minimum of d) or dark (minus the
// smallest run maximum). The circle's offsets are compile-time, so each
// load is one shared-memory access at an immediate offset.
__device__ __forceinline__ float fast_score(const float* p) {
    constexpr int off[16] = {
        -3 * TS, -3 * TS + 1, -2 * TS + 2, -TS + 3, 3, TS + 3, 2 * TS + 2,
        3 * TS + 1, 3 * TS, 3 * TS - 1, 2 * TS - 2, TS - 3, -3, -TS - 3,
        -2 * TS - 2, -3 * TS - 1};
    const float c = p[0];
    float d[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] = p[off[i]] - c;
    return fmaxf(run9_extreme<false>(d), -run9_extreme<true>(d));
}

// Cell stage: block b is cell b of the table's cells; its two winners go to
// slots 2b and 2b + 1 (key, flat pixel index y * W + x, raw score there, 0
// outside the level).
__global__ void __launch_bounds__(CT, CELL_MIN_BLOCKS)
fast_cells_kernel(const float* __restrict__ img,
                  const __grid_constant__ LevelTable lv,
                  float th_lo, float th_hi, float boost, int border,
                  float* __restrict__ key_out, int* __restrict__ idx_out,
                  float* __restrict__ score_out) {
    __shared__ float tile[TILE][TS];
    __shared__ float sc[STILE][STILE];
    __shared__ short todo[STILE * STILE];
    __shared__ int n_todo;
    __shared__ unsigned long long pairs[CW][2];

    const int b = blockIdx.x, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    int l = 0;                              // levels without cells are skipped
    while (l + 1 < lv.n_levels && b >= lv.cell0[l + 1]) ++l;
    const int H = lv.h[l], W = lv.w[l];
    const float* __restrict__ im = img + lv.off[l];
    const int c = b - lv.cell0[l];
    const int cy = c / lv.ncx[l];
    const int y0 = cy * CELL, x0 = (c - cy * lv.ncx[l]) * CELL;
    if (tid == 0) n_todo = 0;

    if (y0 >= HALO && x0 >= HALO && y0 + CELL + HALO <= H &&
        x0 + CELL + HALO <= W) {
        const float* src = im + (size_t)(y0 - HALO) * W + (x0 - HALO);
        for (int t = tid; t < TILE * TILE; t += CT) {
            const int ty = t / TILE, tx = t - ty * TILE;
            tile[ty][tx] = src[(size_t)ty * W + tx];
        }
    } else {
        for (int t = tid; t < TILE * TILE; t += CT) {
            const int ty = t / TILE, tx = t - ty * TILE;
            tile[ty][tx] = im[(size_t)wrap(y0 - HALO + ty, H) * W +
                              wrap(x0 - HALO + tx, W)];
        }
    }
    __syncthreads();

    // Which of the 18 x 18 positions need their score: one above th_lo needs
    // two of the circle's four compass points beyond th_lo on one side
    // (every run of 9 holds two of them). The others keep -inf: each true
    // score there is at most th_lo, below any candidate's, so no NMS
    // comparison or key changes (a winner's raw score is recomputed below).
    // The positions that need one are compacted, so whole warps score them.
    for (int s0 = 0; s0 < STILE * STILE; s0 += CT) {
        const int s = s0 + tid;
        bool need = false;
        if (s < STILE * STILE) {
            const int sy = s / STILE, sx = s - sy * STILE;
            const float* p = &tile[sy + HALO - 1][sx + HALO - 1];
            const float c = p[0];
            const float a0 = p[-3 * TS] - c, a1 = p[3] - c;
            const float a2 = p[3 * TS] - c, a3 = p[-3] - c;
            need = (a0 > th_lo) + (a1 > th_lo) + (a2 > th_lo) + (a3 > th_lo) >= 2 ||
                   (a0 < -th_lo) + (a1 < -th_lo) + (a2 < -th_lo) +
                   (a3 < -th_lo) >= 2;
            if (!need) sc[sy][sx] = -INFINITY;
        }
        const unsigned int ball = __ballot_sync(0xffffffffu, need);
        int base = 0;
        if (lane == 0 && ball) base = atomicAdd(&n_todo, __popc(ball));
        base = __shfl_sync(0xffffffffu, base, 0);
        if (need) todo[base + __popc(ball & ((1u << lane) - 1u))] = (short)s;
    }
    __syncthreads();
    const int nt = n_todo;
    for (int j = tid; j < nt; j += CT) {
        const int s = todo[j], sy = s / STILE, sx = s - sy * STILE;
        sc[sy][sx] = fast_score(&tile[sy + HALO - 1][sx + HALO - 1]);
    }
    __syncthreads();

    // keys of in-cell pixels tid and tid + CT, their top-2
    unsigned long long best = 0ull, second = 0ull;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        const int p = tid + q * CT;
        const int ly = p >> 4, lx = p & 15;
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
        const bool inside = y >= border && y < H - border && x >= border &&
                            x < W - border;
        const bool weak = (s > th_lo) && (s >= neigh) && inside;
        const float key = weak ? s + (s > th_hi ? boost : 0.0f) : -INFINITY;
        const unsigned long long v =
            ((unsigned long long)order_bits(key) << 32) | (0xFFFFu - p);
        merge_top2(best, second, v, 0ull);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        merge_top2(best, second, __shfl_xor_sync(0xffffffffu, best, off),
                   __shfl_xor_sync(0xffffffffu, second, off));
    if (lane == 0) {
        pairs[warp][0] = best;
        pairs[warp][1] = second;
    }
    __syncthreads();
    if (warp == 0) {
        best = lane < CW ? pairs[lane][0] : 0ull;
        second = lane < CW ? pairs[lane][1] : 0ull;
#pragma unroll
        for (int off = CW / 2; off > 0; off >>= 1)
            merge_top2(best, second, __shfl_xor_sync(0xffffffffu, best, off),
                       __shfl_xor_sync(0xffffffffu, second, off));
        if (lane < 2) {
            const unsigned long long v = lane ? second : best;
            const int p = 0xFFFF - (int)(v & 0xFFFFull);
            const int ly = p >> 4, lx = p & 15;
            const int y = y0 + ly, x = x0 + lx;
            float sv = 0.0f;                // 0 outside the level
            if (y < H && x < W) {
                sv = sc[ly + 1][lx + 1];
                if (sv == -INFINITY) sv = fast_score(&tile[ly + HALO][lx + HALO]);
            }
            key_out[2 * b + lane] = from_order_bits((unsigned int)(v >> 32));
            idx_out[2 * b + lane] = y * W + x;
            score_out[2 * b + lane] = sv;
        }
    }
}

// Level stage: block l selects level l's kept slots among its cell winners
// and writes them in order.
//  1. The n keys' order bits go to shared memory. A radix select (4 passes
//     of 8 bits, most significant first, warp-aggregated shared-memory
//     histograms) finds K, the 32-bit key of the keep-th best slot, and
//     `need`, how many of the slots whose key equals K are kept (the first
//     ones by slot: a stable sort keeps them in slot order).
//  2. A block scan over contiguous chunks of slots ranks the slots equal to
//     K; the kept slots (key > K, or equal and among the first `need`) are
//     compacted as 64-bit (order_bits(key) << 32 | ~slot).
//  3. Each kept slot's output position is the number of kept slots with a
//     larger 64-bit value: the order of torch.sort(descending=True,
//     stable=True) over the keys and of jax.lax.top_k, whatever order the
//     compaction wrote them in.
// BIG: the instance for the levels whose selection does not fit in shared
// memory; it keeps the kept slots in sel_g and reads the order bits from
// `key` in each pass. Each instance skips the other's levels.
template <bool BIG>
__global__ void __launch_bounds__(ST)
fast_level_kernel(const __grid_constant__ LevelTable lv,
                  const float* __restrict__ key,
                  const int* __restrict__ idx, const float* __restrict__ score,
                  int* __restrict__ yx_out, float* __restrict__ key_out,
                  float* __restrict__ resp_out, uint8_t* __restrict__ valid_out,
                  float* __restrict__ uv_out, int* __restrict__ oct_out,
                  float* __restrict__ size_out,
                  unsigned long long* __restrict__ sel_g) {
    extern __shared__ unsigned long long dyn[];
    __shared__ int hist[256];
    __shared__ int wsum[ST / 32];
    __shared__ int ctrl[3];                 // digit, need, kept so far
    const int l = blockIdx.x, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int keep = lv.keep[l];
    if (keep == 0 || lv.big[l] != BIG) return;  // the whole block leaves
    const int s0 = 2 * lv.cell0[l];
    const int n = 2 * (lv.cell0[l + 1] - lv.cell0[l]);
    // keep kept slots, then n order bits, in shared memory (BIG: neither)
    unsigned long long* sel = BIG ? sel_g + lv.out0[l] : dyn;
    unsigned int* kb = (unsigned int*)(dyn + keep);
    auto bits = [&](int i) { return BIG ? order_bits(key[s0 + i]) : kb[i]; };
    if (!BIG)
        for (int i = tid; i < n; i += ST) kb[i] = order_bits(key[s0 + i]);
    if (tid == 0) ctrl[2] = 0;

    // 1. radix select
    unsigned int prefix = 0u, mask = 0u;
    int need = keep;
    for (int shift = 24; shift >= 0; shift -= 8) {
        if (tid < 256) hist[tid] = 0;
        __syncthreads();
        for (int i0 = 0; i0 < n; i0 += ST) {
            const int i = i0 + tid;
            const unsigned int u = i < n ? bits(i) : 0u;
            const bool in = i < n && (u & mask) == prefix;
            const int bin = in ? (int)((u >> shift) & 255u) : -1;
            const unsigned int same = __match_any_sync(0xffffffffu, bin);
            if (in && lane == __ffs(same) - 1)
                atomicAdd(&hist[bin], __popc(same));
        }
        __syncthreads();
        if (warp == 0) {
            // lane j holds digits 255 - 8 j .. 248 - 8 j, best first
            int c[8], tot = 0;
#pragma unroll
            for (int q = 0; q < 8; ++q) {
                c[q] = hist[255 - 8 * lane - q];
                tot += c[q];
            }
            int incl = tot;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const int t = __shfl_up_sync(0xffffffffu, incl, off);
                if (lane >= off) incl += t;
            }
            int acc = incl - tot;
            if (acc < need && need <= incl) {
#pragma unroll
                for (int q = 0; q < 8; ++q) {
                    if (acc < need && need <= acc + c[q]) {
                        ctrl[0] = 255 - 8 * lane - q;
                        ctrl[1] = need - acc;
                    }
                    acc += c[q];
                }
            }
        }
        __syncthreads();
        prefix |= (unsigned int)ctrl[0] << shift;
        mask |= 255u << shift;
        need = ctrl[1];
    }

    // 2. rank the slots equal to K in slot order, compact the kept slots
    const int chunk = (n + ST - 1) / ST;
    const int a = min(tid * chunk, n), b = min(a + chunk, n);
    int ne = 0;
    for (int i = a; i < b; ++i) ne += bits(i) == prefix;
    int incl = ne;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const int v = wsum[lane];
        int w = v;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int t = __shfl_up_sync(0xffffffffu, w, off);
            if (lane >= off) w += t;
        }
        wsum[lane] = w - v;                 // exclusive
    }
    __syncthreads();
    int r = wsum[warp] + incl - ne;         // slots equal to K before a
    for (int q = 0; q < chunk; ++q) {
        const int i = a + q;
        const unsigned int u = i < b ? bits(i) : 0u;
        bool take = false;
        if (i < b) {
            if (u > prefix) take = true;
            else if (u == prefix) take = r++ < need;
        }
        const unsigned int ball = __ballot_sync(0xffffffffu, take);
        int base = 0;
        if (lane == 0 && ball) base = atomicAdd(&ctrl[2], __popc(ball));
        base = __shfl_sync(0xffffffffu, base, 0);
        if (take)
            sel[base + __popc(ball & ((1u << lane) - 1u))] =
                ((unsigned long long)u << 32) | (0xFFFFFFFFu - (unsigned int)i);
    }
    __syncthreads();

    // 3. output positions by rank, a thread a kept slot
    const int W = lv.w[l];
    const float scale = lv.scale[l];
    for (int e = tid; e < keep; e += ST) {
        const unsigned long long v = sel[e];
        int o = lv.out0[l];
        for (int f = 0; f < keep; ++f) o += sel[f] > v;
        const int s = s0 + (int)(0xFFFFFFFFu - (unsigned int)(v & 0xFFFFFFFFull));
        const float k = key[s];
        const bool ok = k > -INFINITY;
        const int pix = idx[s];
        const int y = ok ? pix / W : 0, x = ok ? pix % W : 0;
        yx_out[2 * o] = y;
        yx_out[2 * o + 1] = x;
        key_out[o] = k;
        resp_out[o] = score[s];
        valid_out[o] = ok ? 1 : 0;
        uv_out[2 * o] = __fmul_rn((float)x, scale);
        uv_out[2 * o + 1] = __fmul_rn((float)y, scale);
        oct_out[o] = l;
        size_out[o] = lv.size[l];
    }
}

static LevelTable make_table(int n_levels, const int* off, const int* h,
                             const int* w, const int* keep,
                             const float* scale, const float* size) {
    LevelTable lv;
    lv.n_levels = n_levels;
    lv.cell0[0] = 0;
    int out = 0;
    for (int l = 0; l < n_levels; ++l) {
        lv.off[l] = off[l];
        lv.h[l] = h[l];
        lv.w[l] = w[l];
        lv.ncx[l] = (w[l] + CELL - 1) / CELL;
        const int cells = keep[l] ? lv.ncx[l] * ((h[l] + CELL - 1) / CELL) : 0;
        lv.cell0[l + 1] = lv.cell0[l] + cells;
        lv.keep[l] = keep[l];
        lv.out0[l] = out;
        lv.big[l] = 0;
        out += keep[l];
        lv.scale[l] = scale[l];
        lv.size[l] = size[l];
    }
    return lv;
}

// One level (the per-level entry): the cell stage alone, (ncells, 2) slots.
extern "C" int fast_select(const float* img, int H, int W, float th_lo,
                           float th_hi, float boost, int border, float* key,
                           int* idx, float* score, void* stream) {
    const int off = 0, keep = 1;
    const float one = 1.0f;
    const LevelTable lv = make_table(1, &off, &H, &W, &keep, &one, &one);
    if (lv.cell0[1] == 0) return 0;
    fast_cells_kernel<<<lv.cell0[1], CT, 0, (cudaStream_t)stream>>>(
        img, lv, th_lo, th_hi, boost, border, key, idx, score);
    return (int)cudaGetLastError();
}

// Dynamic shared memory a level block may take on the current device.
static cudaError_t level_smem_cap(size_t* cap) {
    static int dev_seen = -1;
    static size_t cap_seen = 0;
    int dev, optin;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess || dev == dev_seen) {
        *cap = cap_seen;
        return e;
    }
    cudaFuncAttributes fa;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e == cudaSuccess)
        e = cudaFuncGetAttributes(&fa, fast_level_kernel<false>);
    if (e != cudaSuccess) return e;
    dev_seen = dev;
    cap_seen = (size_t)optin - fa.sharedSizeBytes;
    *cap = cap_seen;
    return e;
}

// n_levels levels at element offsets `off` of img, of shapes (h, w), keeping
// keep[l] = min(n_keep, 2 ncells) slots of each (0: none). cell_key /
// cell_idx / cell_score hold 2 slots a cell of the kept levels; the outputs
// sum(keep) slots in level order. A level whose selection does not fit in
// shared memory (8 B a kept slot + 4 B a cell slot: above ~28k cells on an
// H100) works in global memory: sel_scratch, 8 B an output slot.
extern "C" int fast_select_levels(
        const float* img, int n_levels, const int* off, const int* h,
        const int* w, const int* keep, const float* scale, const float* size,
        float th_lo, float th_hi, float boost, int border, float* cell_key,
        int* cell_idx, float* cell_score, int* yx, float* key, float* resp,
        uint8_t* valid, float* uv, int* octave, float* size_out,
        unsigned long long* sel_scratch, void* stream) {
    if (n_levels < 1 || n_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
    LevelTable lv = make_table(n_levels, off, h, w, keep, scale, size);
    const int cells = lv.cell0[n_levels];
    if (cells == 0) return 0;
    size_t cap, smem = 0;
    cudaError_t e = level_smem_cap(&cap);
    if (e != cudaSuccess) return (int)e;
    int any_big = 0;
    for (int l = 0; l < n_levels; ++l) {
        const int n = 2 * (lv.cell0[l + 1] - lv.cell0[l]);
        const size_t b = 8 * (size_t)lv.keep[l] + 4 * (size_t)n;
        lv.big[l] = lv.keep[l] && b > cap;
        any_big |= lv.big[l];
        if (b <= cap && b > smem) smem = b;
    }
    e = cudaFuncSetAttribute(
        fast_level_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    cudaStream_t st = (cudaStream_t)stream;
    fast_cells_kernel<<<cells, CT, 0, st>>>(img, lv, th_lo, th_hi, boost,
                                            border, cell_key, cell_idx,
                                            cell_score);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    // the shared-memory instance, then (only if a level needs it) the other
    for (int big = 0; big <= any_big; ++big) {
        const auto kernel = big ? fast_level_kernel<true>
                                : fast_level_kernel<false>;
        kernel<<<n_levels, ST, big ? 0 : smem, st>>>(
            lv, cell_key, cell_idx, cell_score, yx, key, resp, valid, uv,
            octave, size_out, sel_scratch);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}
