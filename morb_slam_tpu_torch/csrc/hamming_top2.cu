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
#include <cuda_runtime.h>
#include <limits.h>
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
