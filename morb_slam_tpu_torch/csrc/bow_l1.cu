// K10: dense L1 scores of BoW vectors against the keyframe database, with
// the database's validity / exclusion mask fused in.
//
// Replaces morb_slam_tpu/vocab/tree.py:l1_score together with the masking
// of morb_slam_tpu/vocab/database.py:query: s = 1 - 0.5 * sum |q - d| for
// every (query, database row), and -1 where the row is invalid or excluded.
// Relocalization scores the whole database once per attempt.
//
// What bounds it on an H100: bytes. The function reads the (K, W) database
// once (K = 256 keyframes x W = 10^4 words x 4 B = 10.2 MB, ~3.1 us at
// 3.35 TB/s) plus the queries, and does 3 flops per element (~7.7 Mflop per
// query, ~0.1 us at 67 TFLOP/s).
//
// Design: one block of 256 threads per (query, row) pair, grid (K, B).
// Masked rows write -1 and read nothing. Otherwise the threads stride over
// the row with 16-byte float4 loads where every row starts 16-byte aligned
// (W divisible by 4), else with scalar loads, sum |q - d| in registers, and
// a warp-shuffle butterfly plus one pass over the 8 warps' partial sums
// finish the reduction. The order of the float sums differs from the plain
// version's, so scores agree to float32 rounding of the sum (~1e-6), not
// bitwise.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define NWARPS (THREADS / 32)

__global__ void __launch_bounds__(THREADS)
bow_l1_kernel(const float* __restrict__ q, const float* __restrict__ db,
              const uint8_t* __restrict__ ok, int K, int W,
              float* __restrict__ scores) {
    __shared__ float part[NWARPS];
    const int row = blockIdx.x, b = blockIdx.y;
    float* out = scores + (size_t)b * K + row;
    if (ok && !ok[row]) {
        if (threadIdx.x == 0) *out = -1.0f;
        return;
    }
    const float* qr = q + (size_t)b * W;
    const float* dr = db + (size_t)row * W;
    float s = 0.0f;
    if ((W & 3) == 0) {
        const float4* q4 = (const float4*)qr;
        const float4* d4 = (const float4*)dr;
        for (int j = threadIdx.x; j < W / 4; j += THREADS) {
            const float4 a = q4[j], c = __ldg(d4 + j);
            s += fabsf(a.x - c.x) + fabsf(a.y - c.y) + fabsf(a.z - c.z) +
                 fabsf(a.w - c.w);
        }
    } else {
        for (int j = threadIdx.x; j < W; j += THREADS)
            s += fabsf(qr[j] - __ldg(dr + j));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
        float tot = 0.0f;
        for (int w = 0; w < NWARPS; ++w) tot += part[w];
        *out = 1.0f - 0.5f * tot;
    }
}

extern "C" int bow_l1(const void* q, const void* db, const void* ok, int B,
                      int K, int W, float* scores, void* stream) {
    if (B == 0 || K == 0) return 0;
    bow_l1_kernel<<<dim3(K, B), THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)db, (const uint8_t*)ok, K, W, scores);
    return (int)cudaGetLastError();
}
