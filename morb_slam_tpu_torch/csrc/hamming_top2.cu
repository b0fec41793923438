// K3: masked Hamming distance with a fused best / best-index / second-best
// reduction per row.
//
// Replaces morb_slam_tpu/ops/hamming.py:hamming_matrix + top2_min (and the
// masking of match_nn), as every morb_slam_tpu/matching.py search uses them.
//
// What bounds it on an H100: bytes. The function must read the (N, M)
// candidate mask once (4.9 MB at 4096 x 1200, ~1.5 us at 3.35 TB/s) plus the
// two descriptor sets; its 16 integer ops per pair (8 XOR + 8 popcount) are
// ~80 Mop at that size, far below the card's integer rate. The reference
// program writes the whole (N, M) int32 distance matrix to device memory and
// reads it back three times for the reductions.
//
// Design: one warp per row, 8 rows per block. The block stages the columns'
// descriptors in shared memory, CHUNK columns at a time; lane j of a warp
// takes columns j, j+32, ... so its mask reads are coalesced with the other
// lanes'. Each lane keeps a running (best, index, second) in registers,
// then a butterfly of warp shuffles merges the 32 partial triples,
// comparing (distance, column) lexicographically so the first column wins
// ties, as jnp.argmin does. Masked pairs count as BIG = 1 << 20. The
// distance matrix never reaches device memory. The cross check of match_nn
// (argmin over rows per column) is a second launch on the transposed
// problem, chosen over 64-bit atomics so both passes stay deterministic.
//
// Gated mode (hamming_top2_gated): the projection searches and the stereo
// row search pass per-row and per-column inputs instead of the mask, and
// the kernel tests each pair's gate itself, so no (N, M) tensor is built
// or read. Per row: uv, the window radius (or the row band), octave, flag;
// per column: uv, octave, flag. Modes: GATE_WINDOW, |du| <= r and |dv| <= r
// as two compares (a NaN difference fails either, as torch.amax
// propagates it), the column's octave in [o - 1, o + 1]; GATE_WINDOW_NAN,
// the same after nan_to_num(d, nan=1e9) (+-inf to +-FLT_MAX); GATE_BAND,
// |v_r - v_c| <= band, 0 <= u_r - u_c <= max_d, |o_r - o_c| <= 1. Both
// flags in every mode. The subtractions and compares are the plain
// composition's float32 operations (no product, so nothing to contract
// into an FMA); octave arithmetic wraps as torch's int32 does.
//
// What bounds the gated mode: operations. Each pair of a flagged row
// costs ~10 (two subtractions, two or four compares, the octave range,
// the flag), each passing pair 16 more; a row without its flag costs
// nothing. The inputs are ~17 B a row and ~13 B a column.
//
// Design: WPR warps a row (the launch picks WPR from N so that ~32 warps
// a multiprocessor hide the latencies), 8 warps a block. Lane j of a row's
// warp q tests columns 32 q + j, then every 32 WPR on, GATED_UNROLL of
// them a step, reading the columns' gate data through the read-only
// cache; only a passing lane reads the column's descriptor and popcounts
// it (the gate passes well under 1% of the pairs). A row without its flag
// skips the loop. A lane's (best, index, second) starts at (BIG, 0, BIG),
// which stands for the failing columns (BIG in the masked form); the
// masked form's lexicographic butterfly merges a warp's lanes, then the
// row's first warp merges its parts in order, so the result is bit for
// bit hamming_top2(a, b, mask) for the mask the plain gate builds.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define BIG (1 << 20)
#define ROWS_PER_BLOCK 8
#define CHUNK 256

__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
hamming_top2_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                    const uint8_t* __restrict__ mask, int N, int M,
                    int* __restrict__ best_out, int* __restrict__ idx_out,
                    int* __restrict__ second_out) {
    __shared__ uint4 sb[2 * CHUNK];
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
    const bool active = row < N;
    uint4 a0 = make_uint4(0, 0, 0, 0), a1 = a0;
    if (active) {
        a0 = a[2 * (size_t)row];
        a1 = a[2 * (size_t)row + 1];
    }
    int best = INT_MAX, bidx = INT_MAX, second = INT_MAX;
    for (int c0 = 0; c0 < M; c0 += CHUNK) {
        const int nc = min(CHUNK, M - c0);
        __syncthreads();
        for (int t = threadIdx.x; t < 2 * nc; t += blockDim.x)
            sb[t] = b[2 * (size_t)c0 + t];
        __syncthreads();
        if (!active) continue;
        const uint8_t* mrow = mask + (size_t)row * M + c0;
        for (int j = lane; j < nc; j += 32) {
            int d = BIG;
            if (mrow[j]) {
                const uint4 b0 = sb[2 * j], b1 = sb[2 * j + 1];
                d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) +
                    __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
                    __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                    __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
            }
            if (d < best) {
                second = best;
                best = d;
                bidx = c0 + j;
            } else if (d < second) {
                second = d;
            }
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const int ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
        const int os = __shfl_xor_sync(0xffffffffu, second, off);
        if (ob < best || (ob == best && oi < bidx)) {
            second = min(os, best);
            best = ob;
            bidx = oi;
        } else {
            second = min(second, ob);
        }
    }
    if (active && lane == 0) {
        best_out[row] = best;
        idx_out[row] = bidx;
        second_out[row] = min(second, BIG);
    }
}

#define GATE_WINDOW 0
#define GATE_WINDOW_NAN 1
#define GATE_BAND 2
#define GATED_WARPS 8          // warps a block
#define GATED_UNROLL 4         // columns a lane tests per step

__device__ __forceinline__ int wrap_add(int a, int b) {
    return (int)((unsigned)a + (unsigned)b);
}

// |x| of an int32 as torch computes it (INT_MIN stays INT_MIN)
__device__ __forceinline__ int wrap_abs(int x) {
    return x < 0 ? (int)(0u - (unsigned)x) : x;
}

// torch.nan_to_num(x, nan=1e9) then |.|
__device__ __forceinline__ float abs_nan_to_num(float x) {
    const float a = fabsf(x);
    return isnan(a) ? 1e9f : (isinf(a) ? 3.402823466e38f : a);
}

template <int MODE>
__device__ __forceinline__ bool gate(float ru, float rv, float rr, int ro,
                                     float max_d, float2 c_uv, int c_oct,
                                     bool c_ok) {
    if (MODE == GATE_BAND) {
        const float disp = __fsub_rn(ru, c_uv.x);
        return c_ok && fabsf(__fsub_rn(rv, c_uv.y)) <= rr && disp >= 0.0f &&
               disp <= max_d && wrap_abs(wrap_add(ro, -c_oct)) <= 1;
    }
    const float du = __fsub_rn(ru, c_uv.x), dv = __fsub_rn(rv, c_uv.y);
    const bool close = MODE == GATE_WINDOW_NAN
        ? (abs_nan_to_num(du) <= rr && abs_nan_to_num(dv) <= rr)
        : (fabsf(du) <= rr && fabsf(dv) <= rr);
    return c_ok && close && c_oct >= wrap_add(ro, -1) &&
           c_oct <= wrap_add(ro, 1);
}

// the lexicographic (distance, column) merge of two (best, index, second)
// triples over disjoint column sets
__device__ __forceinline__ void merge_top2(int& best, int& bidx, int& second,
                                           int ob, int oi, int os) {
    if (ob < best || (ob == best && oi < bidx)) {
        second = min(os, best);
        best = ob;
        bidx = oi;
    } else {
        second = min(second, ob);
    }
}

template <int MODE, int WPR>
__global__ void __launch_bounds__(GATED_WARPS * 32)
hamming_top2_gated_kernel(const uint4* __restrict__ a,
                          const uint4* __restrict__ b,
                          const float2* __restrict__ row_uv,
                          const float* __restrict__ row_r,
                          const int* __restrict__ row_oct,
                          const uint8_t* __restrict__ row_ok,
                          const float2* __restrict__ col_uv,
                          const int* __restrict__ col_oct,
                          const uint8_t* __restrict__ col_ok, int N, int M,
                          float max_d, int* __restrict__ out) {
    __shared__ int part_top[GATED_WARPS][3];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int row = blockIdx.x * (GATED_WARPS / WPR) + warp / WPR;
    const int part = warp % WPR;
    const bool on = row < N && row_ok[row];
    int best = BIG, bidx = 0, second = BIG;
    if (on) {
        const uint4 a0 = a[2 * (size_t)row], a1 = a[2 * (size_t)row + 1];
        const float2 uv = row_uv[row];
        const float rr = row_r[row];
        const int ro = row_oct[row];
        // lane j of part q tests columns q * 32 + j, then every 32 * WPR
        // on: within a lane the columns ascend, so a tie keeps the first
        for (int j0 = part * 32 + lane; j0 < M;
             j0 += 32 * WPR * GATED_UNROLL) {
            bool pass[GATED_UNROLL];
#pragma unroll
            for (int u = 0; u < GATED_UNROLL; ++u) {
                const int j = j0 + u * 32 * WPR;
                pass[u] = j < M &&
                    gate<MODE>(uv.x, uv.y, rr, ro, max_d, __ldg(col_uv + j),
                               __ldg(col_oct + j), __ldg(col_ok + j) != 0);
            }
#pragma unroll
            for (int u = 0; u < GATED_UNROLL; ++u) {
                if (!pass[u]) continue;
                const int j = j0 + u * 32 * WPR;
                const uint4 b0 = __ldg(b + 2 * (size_t)j);
                const uint4 b1 = __ldg(b + 2 * (size_t)j + 1);
                const int d = __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) +
                              __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w) +
                              __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
                              __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
                if (d < best) {
                    second = best;
                    best = d;
                    bidx = j;
                } else if (d < second) {
                    second = d;
                }
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const int ob = __shfl_xor_sync(0xffffffffu, best, off);
            const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
            const int os = __shfl_xor_sync(0xffffffffu, second, off);
            merge_top2(best, bidx, second, ob, oi, os);
        }
    }
    if (WPR > 1) {
        // the row's parts, merged in order by its first warp
        if (lane == 0) {
            part_top[warp][0] = best;
            part_top[warp][1] = bidx;
            part_top[warp][2] = second;
        }
        __syncthreads();
        if (part == 0 && lane == 0)
            for (int q = 1; q < WPR; ++q)
                merge_top2(best, bidx, second, part_top[warp + q][0],
                           part_top[warp + q][1], part_top[warp + q][2]);
    }
    if (part == 0 && lane == 0 && row < N) {
        out[row] = best;
        out[N + row] = bidx;
        out[2 * N + row] = second;
    }
}

template <int MODE, int WPR>
static void launch_gated(const void* a, const void* b, const void* ruv,
                         const void* rr, const void* ro, const void* rok,
                         const void* cuv, const void* co, const void* cok,
                         int N, int M, float max_d, int* out,
                         cudaStream_t stream) {
    const int rows = GATED_WARPS / WPR;
    hamming_top2_gated_kernel<MODE, WPR><<<(N + rows - 1) / rows,
                                           GATED_WARPS * 32, 0, stream>>>(
        (const uint4*)a, (const uint4*)b, (const float2*)ruv,
        (const float*)rr, (const int*)ro, (const uint8_t*)rok,
        (const float2*)cuv, (const int*)co, (const uint8_t*)cok, N, M, max_d,
        out);
}

template <int MODE>
static void launch_mode(int wpr, const void* a, const void* b,
                        const void* ruv, const void* rr, const void* ro,
                        const void* rok, const void* cuv, const void* co,
                        const void* cok, int N, int M, float max_d, int* out,
                        cudaStream_t s) {
    if (wpr >= 8)
        launch_gated<MODE, 8>(a, b, ruv, rr, ro, rok, cuv, co, cok, N, M,
                              max_d, out, s);
    else if (wpr == 4)
        launch_gated<MODE, 4>(a, b, ruv, rr, ro, rok, cuv, co, cok, N, M,
                              max_d, out, s);
    else if (wpr == 2)
        launch_gated<MODE, 2>(a, b, ruv, rr, ro, rok, cuv, co, cok, N, M,
                              max_d, out, s);
    else
        launch_gated<MODE, 1>(a, b, ruv, rr, ro, rok, cuv, co, cok, N, M,
                              max_d, out, s);
}

// out: int32 (3, N): best, best index, second
extern "C" int hamming_top2_gated(const void* a, const void* b,
                                  const void* row_uv, const void* row_r,
                                  const void* row_oct, const void* row_ok,
                                  const void* col_uv, const void* col_oct,
                                  const void* col_ok, int N, int M, int mode,
                                  float max_d, int* out, void* stream) {
    if (N == 0) return 0;
    if (M <= 0 || mode < GATE_WINDOW || mode > GATE_BAND) return -1;
    // warps a row: enough warps for ~32 a multiprocessor
    static int sms[64];
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 64 && sms[dev] == 0)
        cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    const int n_sm = dev < 64 && sms[dev] > 0 ? sms[dev] : 132;
    int wpr = 1;
    while (wpr < 8 && (long long)N * wpr < 32LL * n_sm) wpr *= 2;
    const cudaStream_t s = (cudaStream_t)stream;
    if (mode == GATE_WINDOW)
        launch_mode<GATE_WINDOW>(wpr, a, b, row_uv, row_r, row_oct, row_ok,
                                 col_uv, col_oct, col_ok, N, M, max_d, out, s);
    else if (mode == GATE_WINDOW_NAN)
        launch_mode<GATE_WINDOW_NAN>(wpr, a, b, row_uv, row_r, row_oct,
                                     row_ok, col_uv, col_oct, col_ok, N, M,
                                     max_d, out, s);
    else
        launch_mode<GATE_BAND>(wpr, a, b, row_uv, row_r, row_oct, row_ok,
                               col_uv, col_oct, col_ok, N, M, max_d, out, s);
    return (int)cudaGetLastError();
}

extern "C" int hamming_top2(const void* a, const void* b, const void* mask,
                            int N, int M, int* best, int* idx, int* second,
                            void* stream) {
    if (N == 0) return 0;
    const int blocks = (N + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    hamming_top2_kernel<<<blocks, ROWS_PER_BLOCK * 32, 0, (cudaStream_t)stream>>>(
        (const uint4*)a, (const uint4*)b, (const uint8_t*)mask, N, M, best,
        idx, second);
    return (int)cudaGetLastError();
}
