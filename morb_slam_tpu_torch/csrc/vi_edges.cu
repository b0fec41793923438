// K13: the inertial terms of the visual-inertial window BA at one state,
// in one call: the dense window system H (15W x 15W) and b (15W) with the
// visual pose blocks, the inertial edges, the bias random walk and the bias
// priors, and the inertial cost of the accept test.
//
// Replaces, in morb_slam_tpu/optim/vi_ba.py, `_edge_terms` (:196: the 9-dof
// residual `_edge_residual` and its 9 x 30 Jacobian at zero tangent by
// vmap(jacfwd)), the per-edge J^T Omega J and gradient scattered into the
// dense (15W)^2 system of `_lm_step` (:278-302), the bias random walk
// (:304-313) and the bias priors (:315-321); and `_quad_costs` (:217). The
// plain versions are optim/vi_ba.py:inertial_system_plain and
// inertial_cost_plain.
//
// What bounds it on an H100: latency. One call reads ~0.9 KB of state and
// constants per slot and writes the dense system, (15W)^2 floats: 176 KB at
// W = 14, 0.92 MB at W = 32, a few tenths of a microsecond at 3.35 TB/s.
// Each edge's Jacobian is ~45 kflop of dual-number arithmetic in one serial
// chain per tangent.
//
// Design: one cooperative launch (every block co-resident, one grid
// barrier), no float atomics.
//  - Edges: blocks [0, W) each take window slot e (the edge prev(e) -> e)
//    first. Warp 0's lane d < 30 evaluates the residual on dual numbers
//    seeded with the unit tangent e_d (imu_edge.cuh, K12's device code),
//    giving column d of Je (9 x 30) in shared memory. Meanwhile lane 0 of
//    warp 1 evaluates the residual's values alone and the slot's cost: r^T
//    Omega r and the random walk of a valid edge, and the slot's bias
//    prior. The block then forms J^T Omega (30 x 9), the edge's
//    He = J^T Omega J (30 x 30) and ge = -J^T Omega r (30) and writes them
//    to scratch; an invalid edge (e_valid false; e_prev -1 is clamped to 0)
//    writes only its cost.
//  - Assembly: every block lists, for each slot, the valid edges that
//    touch it (prev and valid are inputs, not the edges' results; in an
//    edge block its warp 2 does this during the dual-number chain). A
//    15 x 15 block (I, J) of H is live if I = J or a valid edge links I
//    and J. The other blocks write the dead chunks' zeros (4 entries of H,
//    one 16-byte store) while the edges run. After the grid barrier every
//    thread takes live chunks and b's entries in a grid stride, and sums
//    each live entry's terms in the order of the earlier thread-per-entry
//    form: the visual pose block, the ii, ij, ji and jj blocks of the
//    edges that touch it in edge order, the random walk, the prior. One
//    warp sums the slots' costs as the earlier cost kernel did: lane t the
//    slots t, t + 32, ..., then a fixed xor butterfly. An edge that
//    touches no entry added nothing to it, so H, b and the cost keep that
//    form's bits; two calls give the same bits.
// The arithmetic follows the plain version's formulas in float32 (its
// forward mode carries some tangents in float64), so the two agree to
// float32 rounding of the Jacobian.
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "imu_edge.cuh"

// per-edge constants, packed by optim/vi_ba.py:_edge_consts
#define E_DT 0
#define E_DR 1
#define E_DV 10
#define E_DP 13
#define E_JRG 16
#define E_JVG 25
#define E_JVA 34
#define E_JPG 43
#define E_JPA 52
#define E_INFO 61
#define E_BIAS0 142
#define E_RW 148
#define E_PRIOR 154
#define N_EC 160
// per-slot body state [R 0, p 9, v 12, b 15]
#define N_ST 21

#define THREADS 256

__device__ __forceinline__ ImuEdge edge_of(const float* c) {
    return ImuEdge{c[E_DT],      c + E_DR,    c + E_DV,    c + E_DP,
                   c + E_JRG,    c + E_JVG,   c + E_JVA,   c + E_JPG,
                   c + E_JPA,    c + E_BIAS0};
}

// the slot's cost: r^T Omega r and the random walk of a valid edge (from
// the residual's values alone), then the slot's bias prior
__device__ __noinline__ float slot_cost(bool valid, const float* sp,
                                        const float* se, const float* c) {
    float ce = 0.0f;
    if (valid) {
        const ImuEdge E = edge_of(c);
        Dl r[9];
        edge_residual(-1, sp, se, E, r);
        for (int i = 0; i < 9; ++i) {
            float s = 0.0f;
            for (int j = 0; j < 9; ++j) s += c[E_INFO + 9 * i + j] * r[j].v;
            ce += r[i].v * s;
        }
        for (int k = 0; k < 6; ++k) {
            const float rr = se[15 + k] - sp[15 + k];
            ce += rr * rr * c[E_RW + k];
        }
    }
    for (int k = 0; k < 6; ++k) ce += se[15 + k] * se[15 + k] * c[E_PRIOR + k];
    return ce;
}

__device__ void build_lists(int W, const int* __restrict__ prev,
                            const uint8_t* __restrict__ valid, int* smem);

// edge e's He (30 x 30), ge (30) and its slot's cost, by the whole block;
// its warp 2 builds the window's lists (Window) in `lists` meanwhile
__device__ void edge_terms(int e, const float* __restrict__ state,
                           const float* __restrict__ cst,
                           const int* __restrict__ prev,
                           const uint8_t* __restrict__ valid,
                           float* __restrict__ He, float* __restrict__ ge,
                           float* __restrict__ ce, int W, int* lists) {
    __shared__ float S[2 * N_ST], C[N_EC];
    __shared__ float Je[9][30], JtW[9][30], re[9];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int p = max(prev[e], 0);
    const bool ok = valid[e];
    for (int q = tid; q < N_ST; q += THREADS) {
        S[q] = state[(size_t)p * N_ST + q];
        S[N_ST + q] = state[(size_t)e * N_ST + q];
    }
    for (int q = tid; q < N_EC; q += THREADS)
        C[q] = cst[(size_t)e * N_EC + q];
    __syncthreads();
    if (warp == 0) {
        if (ok && lane < 30) {
            const ImuEdge E = edge_of(C);
            Dl r[9];
            edge_residual(lane, S, S + N_ST, E, r);
            for (int a = 0; a < 9; ++a) Je[a][lane] = r[a].d;
            if (lane == 0)
                for (int a = 0; a < 9; ++a) re[a] = r[a].v;
        }
    } else if (warp == 1) {
        if (lane == 0) ce[e] = slot_cost(ok, S, S + N_ST, C);
    } else if (warp == 2) {
        build_lists(W, prev, valid, lists);
    }
    __syncthreads();
    if (!ok) return;
    // JtW[b][i] = sum_a Je[a][i] Omega[a][b]
    for (int q = tid; q < 270; q += THREADS) {
        const int b = q / 30, i = q % 30;
        float s = 0.0f;
        for (int a = 0; a < 9; ++a) s += Je[a][i] * C[E_INFO + 9 * a + b];
        JtW[b][i] = s;
    }
    __syncthreads();
    float* he = He + (size_t)e * 900;
    for (int q = tid; q < 900; q += THREADS) {
        const int i = q / 30, j = q % 30;
        float s = 0.0f;
        for (int b = 0; b < 9; ++b) s += JtW[b][i] * Je[b][j];
        he[q] = s;
    }
    if (tid < 30) {
        float s = 0.0f;
        for (int b = 0; b < 9; ++b) s += JtW[b][tid] * re[b];
        ge[(size_t)e * 30 + tid] = -s;
    }
}

// each slot's valid incident edges and linked slots, as bit sets of NW
// words: inc[I] holds e where e == I or prev(e) == I; lnk[I] holds J != I
// linked to I by a valid edge
struct Window {
    int W, NW;
    const int* sp;
    const unsigned* inc;
    const unsigned* lnk;
};

__device__ __forceinline__ bool block_live(const Window& w, int I, int J) {
    return I == J || ((w.lnk[I * w.NW + (J >> 5)] >> (J & 31)) & 1u);
}

// H[15 I + a, 15 J + bb]: the terms of the thread-per-entry form in its
// order, over the edges that touch slot I
__device__ __forceinline__ float h_entry(const Window& w, int I, int J,
                                         int a, int bb,
                                         const float* __restrict__ He,
                                         const float* __restrict__ cst,
                                         const float* __restrict__ Hpp) {
    float s = 0.0f;
    if (I == J && a < 6 && bb < 6) s = Hpp[(size_t)I * 36 + a * 6 + bb];
    for (int wd = 0; wd < w.NW; ++wd)
        for (unsigned m = w.inc[I * w.NW + wd]; m; m &= m - 1) {
            const int e = 32 * wd + __ffs(m) - 1;
            const int p = w.sp[e];
            const float* h = He + (size_t)e * 900;
            if (I == p && J == p) s += h[a * 30 + bb];
            if (I == p && J == e) s += h[a * 30 + 15 + bb];
            if (I == e && J == p) s += h[bb * 30 + 15 + a];
            if (I == e && J == e) s += h[(15 + a) * 30 + 15 + bb];
        }
    if (a == bb && a >= 9) {
        for (int wd = 0; wd < w.NW; ++wd)
            for (unsigned m = w.inc[I * w.NW + wd]; m; m &= m - 1) {
                const int e = 32 * wd + __ffs(m) - 1;
                const int p = w.sp[e];
                const float rw = cst[(size_t)e * N_EC + E_RW + a - 9];
                if (I == p && J == p) s += rw;
                if (I == e && J == e) s += rw;
                if (I == p && J == e) s -= rw;
                if (I == e && J == p) s -= rw;
            }
        if (I == J) s += cst[(size_t)I * N_EC + E_PRIOR + a - 9];
    }
    return s;
}

// b[15 I + a], likewise
__device__ __forceinline__ float b_entry(const Window& w, int I, int a,
                                         const float* __restrict__ ge,
                                         const float* __restrict__ state,
                                         const float* __restrict__ cst,
                                         const float* __restrict__ bp) {
    float s = a < 6 ? bp[(size_t)I * 6 + a] : 0.0f;
    for (int wd = 0; wd < w.NW; ++wd)
        for (unsigned m = w.inc[I * w.NW + wd]; m; m &= m - 1) {
            const int e = 32 * wd + __ffs(m) - 1;
            const int p = w.sp[e];
            if (p == I) s += ge[(size_t)e * 30 + a];
            if (e == I) s += ge[(size_t)e * 30 + 15 + a];
        }
    if (a >= 9) {
        const int k = a - 9;
        for (int wd = 0; wd < w.NW; ++wd)
            for (unsigned m = w.inc[I * w.NW + wd]; m; m &= m - 1) {
                const int e = 32 * wd + __ffs(m) - 1;
                const int p = w.sp[e];
                const float rr = state[(size_t)e * N_ST + 15 + k] -
                                 state[(size_t)p * N_ST + 15 + k];
                const float rw = cst[(size_t)e * N_EC + E_RW + k];
                if (p == I) s += rw * rr;
                if (e == I) s += -rw * rr;
            }
        s += -cst[(size_t)I * N_EC + E_PRIOR + k] *
             state[(size_t)I * N_ST + 15 + k];
    }
    return s;
}

// whether any entry of H's chunk q (entries 4q .. 4q + 3) lies in a live
// block
__device__ __forceinline__ bool chunk_live(const Window& w, int q, int D,
                                           int nH) {
    const int f = 4 * q;
    bool live = false;
    for (int t = 0, r = f / D, c = f % D; t < 4 && f + t < nH; ++t) {
        live |= block_live(w, r / 15, c / 15);
        if (++c == D) { c = 0; ++r; }
    }
    return live;
}

// the window's lists (Window) in shared memory, by one warp
__device__ void build_lists(int W, const int* __restrict__ prev,
                            const uint8_t* __restrict__ valid, int* smem) {
    const int lane = threadIdx.x & 31, NW = (W + 31) / 32;
    int* sp = smem;
    unsigned* inc = (unsigned*)(smem + W);
    unsigned* lnk = inc + W * NW;
    for (int q = lane; q < 2 * W * NW; q += 32) inc[q] = 0u;
    for (int e = lane; e < W; e += 32) sp[e] = max(prev[e], 0);
    __syncwarp();
    for (int e = lane; e < W; e += 32) {
        if (!valid[e]) continue;
        const int p = sp[e];
        atomicOr(inc + e * NW + (e >> 5), 1u << (e & 31));
        if (p != e) {
            atomicOr(inc + p * NW + (e >> 5), 1u << (e & 31));
            atomicOr(lnk + p * NW + (e >> 5), 1u << (e & 31));
            atomicOr(lnk + e * NW + (p >> 5), 1u << (p & 31));
        }
    }
    __syncwarp();
}

__global__ void __launch_bounds__(THREADS)
vi_terms_kernel(int W, const float* __restrict__ state,
                const float* __restrict__ cst, const int* __restrict__ prev,
                const uint8_t* __restrict__ valid,
                const float* __restrict__ Hpp, const float* __restrict__ bp,
                float* __restrict__ He, float* __restrict__ ge,
                float* __restrict__ ce, float* __restrict__ H,
                float* __restrict__ b, float* __restrict__ cost) {
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    extern __shared__ int smem[];
    const int tid = threadIdx.x, NW = (W + 31) / 32;
    const int D = 15 * W, nH = D * D, nq = (nH + 3) / 4;
    // edge blocks: their idle warp 2 builds the lists meanwhile; the
    // others zero the dead chunks while the edges run
    if ((int)blockIdx.x < W) {
        edge_terms(blockIdx.x, state, cst, prev, valid, He, ge, ce, W, smem);
    } else {
        if (tid < 32) build_lists(W, prev, valid, smem);
        __syncthreads();
        const Window w{W, NW, smem, (const unsigned*)(smem + W),
                       (const unsigned*)(smem + W) + W * NW};
        for (int q = (blockIdx.x - W) * THREADS + tid; q < nq;
             q += (gridDim.x - W) * THREADS) {
            if (chunk_live(w, q, D, nH)) continue;
            if (4 * q + 4 <= nH)
                reinterpret_cast<float4*>(H)[q] =
                    make_float4(0.f, 0.f, 0.f, 0.f);
            else
                for (int f = 4 * q; f < nH; ++f) H[f] = 0.0f;
        }
    }
    const Window w{W, NW, smem, (const unsigned*)(smem + W),
                   (const unsigned*)(smem + W) + W * NW};
    grid.sync();
    if (blockIdx.x == gridDim.x - 1 && tid < 32) {
        // the cost: lane t sums slots t, t + 32, ..., then the butterfly
        float acc = 0.0f;
        for (int e = tid; e < W; e += 32) acc += ce[e];
        for (int off = 16; off > 0; off >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (tid == 0) cost[0] = acc;
    }
    const int g0 = blockIdx.x * THREADS + tid, gs = gridDim.x * THREADS;
    for (int q = g0; q < nq + D; q += gs) {
        if (q >= nq) {
            const int r = q - nq;
            b[r] = b_entry(w, r / 15, r % 15, ge, state, cst, bp);
            continue;
        }
        if (!chunk_live(w, q, D, nH)) continue;
        const int f = 4 * q;
        int r = f / D, c = f - r * D;
        float v[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            const int I = r / 15, J = c / 15;
            v[t] = (f + t < nH && block_live(w, I, J))
                       ? h_entry(w, I, J, r - 15 * I, c - 15 * J, He, cst,
                                 Hpp)
                       : 0.0f;
            if (++c == D) { c = 0; ++r; }
        }
        if (f + 4 <= nH)
            reinterpret_cast<float4*>(H)[q] =
                make_float4(v[0], v[1], v[2], v[3]);
        else
            for (int t = 0; f + t < nH; ++t) H[f + t] = v[t];
    }
}

// the most blocks of vi_terms_kernel the card holds at once (cached)
static int max_grid(int W) {
    static int per_sm = -1, sms = 0;
    if (per_sm < 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) ||
            cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ||
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, vi_terms_kernel, THREADS,
                (size_t)(W + 2 * W * ((W + 31) / 32)) * 4))
            return 0;
    }
    return per_sm * sms;
}

extern "C" int vi_terms(const void* state, const void* cst, const void* prev,
                        const void* valid, const void* Hpp, const void* bp,
                        int W, void* He, void* ge, void* ce, void* H,
                        void* b, void* cost, void* stream) {
    const long long D = 15LL * W;
    if (D * D >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    // W edge blocks, then enough blocks for one item (a 4-entry chunk of
    // H or an entry of b) a thread, as far as the card holds them at once
    const long long items = (D * D + 3) / 4 + D;
    const int most = max_grid(W);
    long long grid = W + (items + THREADS - 1) / THREADS;
    if (grid > most) grid = most;
    if (grid < W + 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    const float* st = (const float*)state;
    const float* cs = (const float*)cst;
    const int* pv = (const int*)prev;
    const uint8_t* vd = (const uint8_t*)valid;
    const float* hp = (const float*)Hpp;
    const float* bpp = (const float*)bp;
    float *he = (float*)He, *gep = (float*)ge, *cep = (float*)ce;
    float *Hp = (float*)H, *bb = (float*)b, *co = (float*)cost;
    void* args[] = {&W, &st, &cs, &pv, &vd, &hp, &bpp, &he, &gep, &cep,
                    &Hp, &bb, &co};
    return (int)cudaLaunchCooperativeKernel(
        (const void*)vi_terms_kernel, dim3((unsigned)grid), dim3(THREADS),
        args, (size_t)(W + 2 * W * ((W + 31) / 32)) * 4,
        (cudaStream_t)stream);
}
