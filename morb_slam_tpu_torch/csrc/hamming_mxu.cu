// K19: the whole (N, M) int32 Hamming distance matrix on the int8 tensor
// cores.
//
// Replaces morb_slam_tpu/ops/hamming.py:40 hamming_matrix_mxu, the
// "popcount as matmul" form: with each descriptor's 256 bits unpacked to
// +-1, d(a, b) = popcount(a ^ b) = (256 - <sa, sb>) / 2. The JAX function
// runs the product on the MXU in bf16 with float32 accumulation; here the
// +-1 values are int8 and the product accumulates in int32, so every
// partial sum is exact and the result equals hamming_matrix bit for bit.
//
// What bounds it on an H100: bytes. The function writes the whole (N, M)
// int32 matrix once (19.7 MB at 4096 x 1200, 5.9 us at 3.35 TB/s) and reads
// 32 B a descriptor; its 2 * 256 operations a pair are 2.5 Gop at that
// size, 1.3 us at the dense int8 rate (1,979 TOP/s).
//
// Design: a block of 4 warps computes a 64 x 64 tile of the matrix. It
// stages its 64 rows' and 64 columns' packed words (2 KB a side) in shared
// memory; each warp owns 16 rows and all 64 columns: 8 accumulator tiles of
// mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, K = 256 in 8 k-steps of
// one 32-bit word each. A lane builds its A and B fragments in registers
// straight from the words: a fragment register holds 4 consecutive bits of
// one word as 4 int8 lanes (bit set -> +1, clear -> -1), the nibble spread
// to bytes by one multiply (x 0x00204081, then & 0x01010101). So the +-1
// tiles never exist in shared memory (the TPU form unpacks them to a
// (N, 256) bf16 array in device memory first). Each lane writes its
// accumulators as (256 - acc) >> 1, the ragged edges masked. A later
// design would stage the output tile for wide coalesced stores, or use
// wgmma and the bit-packed b1 MMA.
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 64
#define WARPS 4

// 4 bits of w from bit `shift` on as 4 int8 lanes: +1 where set, -1 where
// clear (byte j from bit shift + j)
__device__ __forceinline__ uint32_t pm1(uint32_t w, int shift) {
    const uint32_t spread = (((w >> shift) & 0xFu) * 0x00204081u) & 0x01010101u;
    return 0xFFFFFFFFu ^ (spread * 0xFEu);
}

__global__ void __launch_bounds__(WARPS * 32)
hamming_mxu_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                   int N, int M, int* __restrict__ out) {
    __shared__ uint32_t sa[TILE][9];     // a row's 8 words, padded
    __shared__ uint32_t sb[TILE][9];
    const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
    const int tid = threadIdx.x;
    // stage: thread i loads half of row (or column) i / 2's 32 bytes
    for (int i = tid; i < 2 * TILE * 2; i += WARPS * 32) {
        const int side = i / (2 * TILE), r = (i % (2 * TILE)) / 2,
                  half = i % 2;
        const int g = (side == 0 ? row0 : col0) + r;
        const int lim = side == 0 ? N : M;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (g < lim) v = (side == 0 ? a : b)[2 * (long long)g + half];
        uint32_t(*s)[9] = side == 0 ? sa : sb;
        s[r][4 * half + 0] = v.x;
        s[r][4 * half + 1] = v.y;
        s[r][4 * half + 2] = v.z;
        s[r][4 * half + 3] = v.w;
    }
    __syncthreads();

    const int warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;     // groupID, thread in group
    const int wr = warp * 16;                  // the warp's first tile row
    int acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0;

#pragma unroll
    for (int s = 0; s < 8; ++s) {              // k-step s: bits of word s
        const uint32_t w_lo = sa[wr + g][s], w_hi = sa[wr + g + 8][s];
        // A (16 x 32, row): a0 row g k 4t..4t+3, a1 row g+8, a2 row g
        // k 16+4t.., a3 row g+8 k 16+4t..
        const uint32_t a0 = pm1(w_lo, 4 * t), a1 = pm1(w_hi, 4 * t),
                       a2 = pm1(w_lo, 16 + 4 * t), a3 = pm1(w_hi, 16 + 4 * t);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            // B (32 x 8, col): column g of n-tile j, k 4t.. and 16+4t..
            const uint32_t wb = sb[8 * j + g][s];
            const uint32_t b0 = pm1(wb, 4 * t), b1 = pm1(wb, 16 + 4 * t);
            asm volatile(
                "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
                "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                "{%0, %1, %2, %3};\n"
                : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]),
                  "+r"(acc[j][3])
                : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
        }
    }

    // C (16 x 8): c0, c1 row g columns 2t, 2t+1; c2, c3 row g+8
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int col = col0 + 8 * j + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = row0 + wr + g + 8 * h;
            if (row >= N) continue;
            int* o = out + (long long)row * M + col;
            if (col < M) o[0] = (256 - acc[j][2 * h]) >> 1;
            if (col + 1 < M) o[1] = (256 - acc[j][2 * h + 1]) >> 1;
        }
    }
}

extern "C" int hamming_mxu(const void* a, const void* b, int N, int M,
                           int* out, void* stream) {
    if (N == 0 || M == 0) return 0;
    const dim3 grid((M + TILE - 1) / TILE, (N + TILE - 1) / TILE);
    hamming_mxu_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const uint4*)a, (const uint4*)b, N, M, out);
    return (int)cudaGetLastError();
}
