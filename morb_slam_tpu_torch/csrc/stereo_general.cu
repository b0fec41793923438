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
// flag tests) and 8 XOR + 8 popcount, once for the row search and once
// for the column search: ~30 operations a pair, ~90 Mop at 1200 x 1200,
// ~1.3 us at the float32 rate. The reference program writes the (NL, NR)
// residual and distance matrices to device memory and reads them back for
// two argmins.
//
// Design: three kernels in one call, no matrix in device memory.
//  - Rows: one warp per left feature, 8 per block. Lane 0's E b_l (E from
//    the wrapper, the plain version's own product) goes to every lane; the
//    block stages the right features' descriptors, bearings, octaves and
//    flags in shared memory, CHUNK at a time; lane j takes columns j,
//    j + 32, ... and keeps a running (distance, column) minimum, masked
//    pairs counting BIG as the reference's jnp.where(cand, dist, BIG)
//    does; a butterfly of shuffles merges the lanes lexicographically, so
//    the first column wins ties as argmin does. E b_l goes to scratch.
//  - Columns: the same over left features per right feature (the cross
//    check's argmin over rows, first row on ties), reading E b_l back.
//  - Rows again, one thread each: the cross check, then the midpoint
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
#define WARPS 8
#define CHUNK 256

struct Feat {
    uint4 d0, d1;
    float b0, b1, b2;
    int oct;
    int ok;
};

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

__device__ __forceinline__ void warp_argmin(int& best, int& bidx) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const int ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
        if (ob < best || (ob == best && oi < bidx)) {
            best = ob;
            bidx = oi;
        }
    }
}

// One warp per query feature (rows: left against right with its own E b_l;
// columns: right against left with the left features' E b_l as their
// bearings). `qb` is the query's vector in the dot product.
__global__ void __launch_bounds__(WARPS * 32)
search_kernel(const uint4* __restrict__ qdesc, const int* __restrict__ qoct,
              const uint8_t* __restrict__ qok, const float* __restrict__ qvec,
              const float* __restrict__ E, int nq,
              const uint4* __restrict__ tdesc, const int* __restrict__ toct,
              const uint8_t* __restrict__ tok, const float* __restrict__ tvec,
              int nt, float* __restrict__ ebl_out, int* __restrict__ best_out,
              int* __restrict__ idx_out) {
    __shared__ Feat sf[CHUNK];
    const int lane = threadIdx.x & 31;
    const int q = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const bool active = q < nq;
    uint4 a0 = make_uint4(0, 0, 0, 0), a1 = a0;
    float e0 = 0.0f, e1 = 0.0f, e2 = 0.0f;
    int qo = 0, qv = 0;
    if (active) {
        a0 = qdesc[2 * (size_t)q];
        a1 = qdesc[2 * (size_t)q + 1];
        qo = qoct[q];
        qv = qok[q];
        const float* b = qvec + 3 * (size_t)q;
        if (E) {  // rows: E b_l, each entry summed left to right
            e0 = E[0] * b[0] + E[1] * b[1] + E[2] * b[2];
            e1 = E[3] * b[0] + E[4] * b[1] + E[5] * b[2];
            e2 = E[6] * b[0] + E[7] * b[1] + E[8] * b[2];
            if (lane == 0 && ebl_out) {
                ebl_out[3 * (size_t)q] = e0;
                ebl_out[3 * (size_t)q + 1] = e1;
                ebl_out[3 * (size_t)q + 2] = e2;
            }
        } else {
            e0 = b[0];
            e1 = b[1];
            e2 = b[2];
        }
    }
    int best = INT_MAX, bidx = INT_MAX;
    for (int c0 = 0; c0 < nt; c0 += CHUNK) {
        const int nc = min(CHUNK, nt - c0);
        __syncthreads();
        for (int t = threadIdx.x; t < nc; t += blockDim.x) {
            const int j = c0 + t;
            Feat f;
            f.d0 = tdesc[2 * (size_t)j];
            f.d1 = tdesc[2 * (size_t)j + 1];
            f.b0 = tvec[3 * (size_t)j];
            f.b1 = tvec[3 * (size_t)j + 1];
            f.b2 = tvec[3 * (size_t)j + 2];
            f.oct = toct[j];
            f.ok = tok[j];
            sf[t] = f;
        }
        __syncthreads();
        if (!active) continue;
        for (int t = lane; t < nc; t += 32) {
            const Feat& f = sf[t];
            int d = BIG;
            // rows: (E b_l) . b_r; columns: (E b_l) . b_r with the
            // operands the other way round (products commute exactly)
            const float ep = E ? ep_of(e0, e1, e2, f.b0, f.b1, f.b2)
                               : ep_of(f.b0, f.b1, f.b2, e0, e1, e2);
            if (ep < EP_GATE && abs(qo - f.oct) <= 1 && qv && f.ok)
                d = hamming8(a0, a1, f.d0, f.d1);
            if (d < best) {
                best = d;
                bidx = c0 + t;
            }
        }
    }
    warp_argmin(best, bidx);
    if (active && lane == 0) {
        if (best_out) best_out[q] = best;
        idx_out[q] = bidx;
    }
}

// The cross check, triangulation and gates, one thread per left feature,
// in ops/stereo.py:_triangulate_gate's order of operations.
__global__ void triangulate_kernel(
    const float* __restrict__ bear_l, const float* __restrict__ bear_r,
    const float* __restrict__ uv_l, const float* __restrict__ uv_r,
    const float* __restrict__ sigma2, const float* __restrict__ R,
    const float* __restrict__ t, const float* __restrict__ cam_l,
    const float* __restrict__ cam_r, int kind_l, int kind_r, int nl,
    float max_chi2, float max_cos, const int* __restrict__ row_best,
    const int* __restrict__ row_idx, const int* __restrict__ col_idx,
    float* __restrict__ u_right, float* __restrict__ depth,
    uint8_t* __restrict__ valid, int* __restrict__ idx_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= nl) return;
    const int j = row_idx[i];
    const bool matched = row_best[i] <= TH_ORB && col_idx[j] == i;
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

extern "C" int stereo_general(
    const void* desc_l, const void* desc_r, const void* oct_l,
    const void* oct_r, const void* valid_l, const void* valid_r,
    const void* bear_l, const void* bear_r, const void* uv_l,
    const void* uv_r, const void* sigma2, const void* R, const void* t,
    const void* E, const void* cam_l, const void* cam_r, int kind_l,
    int kind_r, int nl, int nr, float max_chi2, float max_cos, void* ebl,
    void* row_best, void* row_idx, void* col_idx, void* u_right,
    void* depth, void* valid, void* idx, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    search_kernel<<<(nl + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
        (const uint4*)desc_l, (const int*)oct_l, (const uint8_t*)valid_l,
        (const float*)bear_l, (const float*)E, nl, (const uint4*)desc_r,
        (const int*)oct_r, (const uint8_t*)valid_r, (const float*)bear_r, nr,
        (float*)ebl, (int*)row_best, (int*)row_idx);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    search_kernel<<<(nr + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
        (const uint4*)desc_r, (const int*)oct_r, (const uint8_t*)valid_r,
        (const float*)bear_r, nullptr, nr, (const uint4*)desc_l,
        (const int*)oct_l, (const uint8_t*)valid_l, (const float*)ebl, nl,
        nullptr, nullptr, (int*)col_idx);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    triangulate_kernel<<<(nl + 127) / 128, 128, 0, s>>>(
        (const float*)bear_l, (const float*)bear_r, (const float*)uv_l,
        (const float*)uv_r, (const float*)sigma2, (const float*)R,
        (const float*)t, (const float*)cam_l, (const float*)cam_r, kind_l,
        kind_r, nl, max_chi2, max_cos, (const int*)row_best,
        (const int*)row_idx, (const int*)col_idx, (float*)u_right,
        (float*)depth, (uint8_t*)valid, (int*)idx);
    return (int)cudaGetLastError();
}
