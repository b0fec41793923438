// K16: the non-rectified two-camera match of the fisheye rig: epipolar
// gate, gated Hamming argmin with a cross check, midpoint triangulation
// and the two-view gates.
//
// Replaces morb_slam_tpu/ops/stereo.py:match_stereo_general, which the
// rig's front end (morb_slam_tpu/pipeline/tracking.py:
// extract_stereo_general_frame) runs on every pair. The plain version is
// ops/stereo.py:match_stereo_general_plain.
//
// What bounds it on an H100: operations, and few of them. The function
// reads the two feature sets (~60 B a feature: descriptor, bearing,
// pixel, octave, flag, sigma2) and writes three (NL,) results: ~0.2 MB at
// 1200 x 1200, 0.05 us at 3.35 TB/s. Each of the NL x NR pairs costs its
// gate (3 products and 2 sums of the epipolar residual, the octave and
// flag tests) and, for a candidate, 8 XOR + 8 popcount: ~10 operations a
// pair and 16 a candidate, ~17 Mop at 1200 x 1200 with the rig's ~175,000
// candidates, 0.26 us at the float32 rate. The reference program writes
// the (NL, NR) residual and distance matrices to device memory and reads
// them back for two argmins.
//
// Design: two kernels in one call, no matrix in device memory.
//  - Pairs (general_pairs_kernel): the NL x NR pairs in 64 x 64 tiles, a
//    block of 8 warps a tile (361 blocks at 1200 x 1200, all co-resident).
//    The block stages its 64 left features with E b_l (E from the wrapper,
//    the plain version's own product; each entry summed left to right) in
//    shared memory; lane j holds right features j and 32 + j of the tile
//    in registers; warp w walks rows 8w .. 8w + 7. Each pair is evaluated
//    once: the residual |E b_l . b_r| in the row search's operand order
//    (the column search needs no other: the products commute exactly),
//    the octave and flag tests, the distance
//    for candidates; masked pairs count BIG, as the reference's
//    jnp.where(cand, dist, BIG). The pair folds into its row's and its
//    column's minimum of the key (distance, index), compared as one
//    integer: the first index wins ties in both directions, as argmin
//    does. Rows merge over the lanes (__reduce_min_sync), columns over
//    the warps in shared memory; each tile writes one key per row and per
//    column (row_part (tiles across, NL), col_part (tiles down, NR)): the
//    merge is on integers, so exact and independent of order.
//  - Rows (triangulate_kernel), one warp each, a programmatic dependent
//    launch that waits for the pairs (griddepcontrol): the lanes merge the
//    row's key over the column tiles and the matched column's key over
//    the row tiles (the cross check), then lane 0 runs the midpoint
//    triangulation, both projections (kb8.cuh) and the gates.
// The float work repeats the plain version's operations in its order and
// is compiled without FMA contraction (ops/cuda_build.py), so the gate and
// the triangulation round as the plain version does on the card.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "kb8.cuh"

#define BIG (1 << 20)
#define TH_ORB 75
#define EP_GATE 0.01f
#define TILE 64                        // rows and columns of a pair tile
#define PAIR_WARPS 8
#define ROWS_PER_WARP (TILE / PAIR_WARPS)
#define TRI_WARPS 4                    // rows a block of the rows kernel

__device__ __forceinline__ int hamming8(uint4 a0, uint4 a1, uint4 b0,
                                        uint4 b1) {
    return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z) +
           __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y) +
           __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

// |Eb . b| summed left to right, as ops/stereo.py:epipolar_residual
__device__ __forceinline__ float ep_of(float e0, float e1, float e2, float b0,
                                      float b1, float b2) {
    return fabsf(e0 * b0 + e1 * b1 + e2 * b2);
}

// a tile's key: distance (<= BIG, 21 bits) above a 6-bit index in the tile
__device__ __forceinline__ unsigned tile_key(int d, int i) {
    return ((unsigned)d << 6) | (unsigned)i;
}

// the global key: distance above the feature's index
__device__ __forceinline__ unsigned long long global_key(unsigned k,
                                                         int base) {
    return ((unsigned long long)(k >> 6) << 32) |
           (unsigned)(base + (int)(k & 63u));
}

__global__ void __launch_bounds__(PAIR_WARPS * 32)
general_pairs_kernel(const uint4* __restrict__ desc_l,
                     const int* __restrict__ oct_l,
                     const uint8_t* __restrict__ ok_l,
                     const float* __restrict__ bear_l,
                     const float* __restrict__ E, int nl,
                     const uint4* __restrict__ desc_r,
                     const int* __restrict__ oct_r,
                     const uint8_t* __restrict__ ok_r,
                     const float* __restrict__ bear_r, int nr,
                     unsigned long long* __restrict__ row_part,
                     unsigned long long* __restrict__ col_part) {
    // the rows kernel may start; it waits for this grid before reading
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    __shared__ uint4 sd0[TILE], sd1[TILE];
    __shared__ float se[TILE][3];
    __shared__ int so[TILE], sok[TILE];
    __shared__ unsigned cmin[PAIR_WARPS][TILE];
    const int c0 = blockIdx.x * TILE, r0 = blockIdx.y * TILE;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid < TILE && r0 + tid < nl) {
        const int i = r0 + tid;
        sd0[tid] = desc_l[2 * (size_t)i];
        sd1[tid] = desc_l[2 * (size_t)i + 1];
        const float* b = bear_l + 3 * (size_t)i;
        // E b_l, each entry summed left to right
        se[tid][0] = E[0] * b[0] + E[1] * b[1] + E[2] * b[2];
        se[tid][1] = E[3] * b[0] + E[4] * b[1] + E[5] * b[2];
        se[tid][2] = E[6] * b[0] + E[7] * b[1] + E[8] * b[2];
        so[tid] = oct_l[i];
        sok[tid] = ok_l[i];
    }
    uint4 d0[2], d1[2];
    float b0[2], b1[2], b2[2];
    int ro[2], rok[2], real[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        const int j = c0 + 32 * q + lane;
        real[q] = j < nr;
        const int jj = real[q] ? j : c0;
        d0[q] = desc_r[2 * (size_t)jj];
        d1[q] = desc_r[2 * (size_t)jj + 1];
        b0[q] = bear_r[3 * (size_t)jj];
        b1[q] = bear_r[3 * (size_t)jj + 1];
        b2[q] = bear_r[3 * (size_t)jj + 2];
        ro[q] = oct_r[jj];
        rok[q] = ok_r[jj];
    }
    __syncthreads();
    unsigned cbest[2] = {UINT_MAX, UINT_MAX};
    for (int t = 0; t < ROWS_PER_WARP; ++t) {
        const int lr = warp * ROWS_PER_WARP + t;
        if (r0 + lr >= nl) break;                   // warp-uniform
        const float e0 = se[lr][0], e1 = se[lr][1], e2 = se[lr][2];
        const uint4 a0 = sd0[lr], a1 = sd1[lr];
        const int qo = so[lr], qv = sok[lr];
        unsigned rkey = UINT_MAX;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            if (!real[q]) continue;
            int d = BIG;
            if (ep_of(e0, e1, e2, b0[q], b1[q], b2[q]) < EP_GATE &&
                abs(qo - ro[q]) <= 1 && qv && rok[q])
                d = hamming8(a0, a1, d0[q], d1[q]);
            rkey = min(rkey, tile_key(d, 32 * q + lane));
            cbest[q] = min(cbest[q], tile_key(d, lr));
        }
        rkey = __reduce_min_sync(0xffffffffu, rkey);
        if (lane == 0)
            row_part[(size_t)blockIdx.x * nl + r0 + lr] = global_key(rkey, c0);
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) cmin[warp][32 * q + lane] = cbest[q];
    __syncthreads();
    if (tid < TILE && c0 + tid < nr) {
        unsigned m = cmin[0][tid];
#pragma unroll
        for (int w = 1; w < PAIR_WARPS; ++w) m = min(m, cmin[w][tid]);
        col_part[(size_t)blockIdx.y * nr + c0 + tid] = global_key(m, r0);
    }
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

// The cross check, triangulation and gates, one warp per left feature: the
// lanes merge the tiles' keys, lane 0 triangulates in
// ops/stereo.py:_triangulate_gate's order of operations.
__global__ void triangulate_kernel(
    const float* __restrict__ bear_l, const float* __restrict__ bear_r,
    const float* __restrict__ uv_l, const float* __restrict__ uv_r,
    const float* __restrict__ sigma2, const float* __restrict__ R,
    const float* __restrict__ t, const float* __restrict__ cam_l,
    const float* __restrict__ cam_r, int kind_l, int kind_r, int nl, int nr,
    float max_chi2, float max_cos,
    const unsigned long long* __restrict__ row_part,
    const unsigned long long* __restrict__ col_part,
    float* __restrict__ u_right, float* __restrict__ depth,
    uint8_t* __restrict__ valid, int* __restrict__ idx_out) {
    const int i = blockIdx.x * TRI_WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (i >= nl) return;
    asm volatile("griddepcontrol.wait;" ::: "memory");
    // the row's (distance, column) over the column tiles, then the
    // matched column's (distance, row) over the row tiles
    const int n_ct = (nr + TILE - 1) / TILE, n_rt = (nl + TILE - 1) / TILE;
    unsigned long long rk = ULLONG_MAX;
    for (int c = lane; c < n_ct; c += 32)
        rk = min(rk, row_part[(size_t)c * nl + i]);
    rk = warp_min(rk);
    const int best = (int)(rk >> 32), j = (int)(rk & 0xffffffffu);
    bool matched = best <= TH_ORB;
    if (matched) {
        unsigned long long ck = ULLONG_MAX;
        for (int r = lane; r < n_rt; r += 32)
            ck = min(ck, col_part[(size_t)r * nr + j]);
        matched = (int)(warp_min(ck) & 0xffffffffu) == i;
    }
    if (lane != 0) return;
    idx_out[i] = matched ? j : -1;
    u_right[i] = -1.0f;
    depth[i] = -1.0f;
    valid[i] = 0;
    if (!matched) return;
    const float d1[3] = {bear_l[3 * i], bear_l[3 * i + 1], bear_l[3 * i + 2]};
    const float* br = bear_r + 3 * (size_t)j;
    float d2[3], c2[3];
    for (int k = 0; k < 3; ++k) {
        d2[k] = R[k] * br[0] + R[3 + k] * br[1] + R[6 + k] * br[2];
        c2[k] = -(R[k] * t[0] + R[3 + k] * t[1] + R[6 + k] * t[2]);
    }
    const float a11 = d1[0] * d1[0] + d1[1] * d1[1] + d1[2] * d1[2];
    const float a12 = -(d1[0] * d2[0] + d1[1] * d2[1] + d1[2] * d2[2]);
    const float a22 = d2[0] * d2[0] + d2[1] * d2[1] + d2[2] * d2[2];
    const float b1 = d1[0] * c2[0] + d1[1] * c2[1] + d1[2] * c2[2];
    const float b2 = -(d2[0] * c2[0] + d2[1] * c2[1] + d2[2] * c2[2]);
    float det = a11 * a22 - a12 * a12;
    if (fabsf(det) < 1e-12f) det = 1e-12f;
    const float alpha = (b1 * a22 - b2 * a12) / det;
    const float beta = (a11 * b2 - a12 * b1) / det;
    float X[3], Xr[3];
    for (int k = 0; k < 3; ++k)
        X[k] = 0.5f * (alpha * d1[k] + c2[k] + beta * d2[k]);
    const float cosp = d1[0] * d2[0] + d1[1] * d2[1] + d1[2] * d2[2];
    for (int k = 0; k < 3; ++k)
        Xr[k] = R[3 * k] * X[0] + R[3 * k + 1] * X[1] + R[3 * k + 2] * X[2] +
                t[k];
    float ul, vl, ur, vr;
    project_raw(kind_l, cam_l, X[0], X[1], X[2], &ul, &vl);
    project_raw(kind_r, cam_r, Xr[0], Xr[1], Xr[2], &ur, &vr);
    const float dul = ul - uv_l[2 * i], dvl = vl - uv_l[2 * i + 1];
    const float dur = ur - uv_r[2 * (size_t)j], dvr = vr - uv_r[2 * (size_t)j + 1];
    const float e_l = (dul * dul + dvl * dvl) / sigma2[i];
    const float e_r = (dur * dur + dvr * dvr) / sigma2[i];
    if (alpha > 0.0f && beta > 0.0f && X[2] > 0.0f && Xr[2] > 0.0f &&
        cosp < max_cos && e_l < max_chi2 && e_r < max_chi2) {
        u_right[i] = uv_r[2 * (size_t)j];
        depth[i] = X[2];
        valid[i] = 1;
    }
}

// row_part: (ceil(nr / TILE), nl) and col_part: (ceil(nl / TILE), nr)
// uint64 scratch, every entry written by the pairs kernel.
extern "C" int stereo_general(
    const void* desc_l, const void* desc_r, const void* oct_l,
    const void* oct_r, const void* valid_l, const void* valid_r,
    const void* bear_l, const void* bear_r, const void* uv_l,
    const void* uv_r, const void* sigma2, const void* R, const void* t,
    const void* E, const void* cam_l, const void* cam_r, int kind_l,
    int kind_r, int nl, int nr, float max_chi2, float max_cos,
    void* row_part, void* col_part, void* u_right, void* depth, void* valid,
    void* idx, void* stream) {
    if (nl == 0 || nr == 0) return 0;
    if ((nl + TILE - 1) / TILE > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    general_pairs_kernel<<<dim3((nr + TILE - 1) / TILE,
                                (nl + TILE - 1) / TILE),
                           PAIR_WARPS * 32, 0, s>>>(
        (const uint4*)desc_l, (const int*)oct_l, (const uint8_t*)valid_l,
        (const float*)bear_l, (const float*)E, nl, (const uint4*)desc_r,
        (const int*)oct_r, (const uint8_t*)valid_r, (const float*)bear_r, nr,
        (unsigned long long*)row_part, (unsigned long long*)col_part);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((nl + TRI_WARPS - 1) / TRI_WARPS);
    cfg.blockDim = dim3(TRI_WARPS * 32);
    cfg.stream = s;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    at[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    rc = (int)cudaLaunchKernelEx(
        &cfg, triangulate_kernel, (const float*)bear_l,
        (const float*)bear_r, (const float*)uv_l, (const float*)uv_r,
        (const float*)sigma2, (const float*)R, (const float*)t,
        (const float*)cam_l, (const float*)cam_r, kind_l, kind_r, nl, nr,
        max_chi2, max_cos, (const unsigned long long*)row_part,
        (const unsigned long long*)col_part, (float*)u_right, (float*)depth,
        (uint8_t*)valid, (int*)idx);
    if (rc) return rc;
    return (int)cudaGetLastError();
}
