// K9: descriptors -> vocabulary words, the descent through every level of
// the k-ary tree in one launch.
//
// Replaces morb_slam_tpu/vocab/tree.py:transform, which every keyframe
// insert (the place-recognition database add) and every relocalization
// query run over the frame's descriptors.
//
// What bounds it on an H100: bytes and latency. Per descriptor the function
// reads its 32 B and writes a 4 B word id; the tree's centers are read once
// (k = 10, depth = 4: 11,110 x 32 B = 355 KB). Its integer work is
// depth x k x 16 ops per descriptor (640 at k = 10, depth = 4): 1200
// descriptors need ~0.8 Mop. At these sizes the four dependent levels of
// gathers set the time.
//
// Design: one thread per descriptor, 128 per block. The block stages the
// center rows of the upper levels (all but the leaves; 1,110 rows, 35 KB at
// k = 10, depth = 4) in shared memory, up to SHARED_ROWS rows; rows past
// that (the 10^4 leaves) are read from device memory through L2. Per level
// the thread XORs its descriptor with the k children of its node, sums the
// 8 `__popc`s and keeps the first child of the least distance, as
// jnp.argmin does. Invalid descriptors get -1. Integer arithmetic only: the
// result is exact.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define SHARED_ROWS 1536  // 48 KB of uint4 pairs

__global__ void __launch_bounds__(THREADS)
vocab_transform_kernel(const uint4* __restrict__ desc,
                       const uint8_t* __restrict__ valid, int N,
                       const uint4* __restrict__ centers, int k, int depth,
                       int n_shared, int* __restrict__ words) {
    __shared__ uint4 sc[2 * SHARED_ROWS];
    for (int r = threadIdx.x; r < 2 * n_shared; r += THREADS)
        sc[r] = centers[r];
    __syncthreads();
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= N) return;
    if (valid && !valid[i]) {
        words[i] = -1;
        return;
    }
    const uint4 d0 = desc[2 * (size_t)i], d1 = desc[2 * (size_t)i + 1];
    int node = 0;       // position within the level
    int base = 0;       // first center row of the level
    int width = k;      // rows of the level
    for (int level = 0; level < depth; ++level) {
        const int first = base + node * k;
        int best = 0x7fffffff, arg = 0;
        for (int j = 0; j < k; ++j) {
            const int r = first + j;
            const uint4* c = r < n_shared ? sc + 2 * r : centers + 2 * (size_t)r;
            const uint4 c0 = c[0], c1 = c[1];
            const int d = __popc(d0.x ^ c0.x) + __popc(d0.y ^ c0.y) +
                          __popc(d0.z ^ c0.z) + __popc(d0.w ^ c0.w) +
                          __popc(d1.x ^ c1.x) + __popc(d1.y ^ c1.y) +
                          __popc(d1.z ^ c1.z) + __popc(d1.w ^ c1.w);
            if (d < best) {
                best = d;
                arg = j;
            }
        }
        node = node * k + arg;
        base += width;
        width *= k;
    }
    words[i] = node;
}

extern "C" int vocab_transform(const void* desc, const void* valid, int N,
                               const void* centers, int k, int depth,
                               int n_upper, int* words, void* stream) {
    if (N == 0) return 0;
    const int n_shared = n_upper < SHARED_ROWS ? n_upper : SHARED_ROWS;
    const int blocks = (N + THREADS - 1) / THREADS;
    vocab_transform_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint4*)desc, (const uint8_t*)valid, N, (const uint4*)centers,
        k, depth, n_shared, words);
    return (int)cudaGetLastError();
}
