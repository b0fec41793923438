// K17: the Gauss-Newton system of the IMU initialization (gravity
// direction, scale, biases and one velocity per keyframe slot, poses
// fixed): H, g and the cost at one point.
//
// Replaces, in morb_slam_tpu/optim/inertial.py:inertial_only_optimize, the
// residuals' jax.jacfwd over all 9 + 3K parameters and the normal
// equations built from it (gn_step, :356-379), and cost_of (:351). The
// plain version is optim/inertial.py:inertial_system_plain; the damping,
// the dense solve and the accept test stay PyTorch on the device.
//
// What bounds it on an H100: bytes, barely. One system reads ~0.65 KB of
// constants and poses per live edge and writes the dense (9 + 3K)^2 H:
// 2.4 MB at K = 256 slots, ~0.7 us at 3.35 TB/s. Each live edge's 15
// Jacobian columns are ~30 kflop of dual-number arithmetic. The reference
// program differentiates every residual along all 777 parameters (a
// (K, 9, 777) Jacobian) and contracts it densely. Only the edges of weight
// w != 0 are live (9-13 of 256 slots on the tracker's path), and an entry
// of H is non-zero only where a live edge touches both its parameters.
//
// Design: two launches, the second a programmatic dependent launch
// (griddepcontrol), no float atomics.
//  - Edges: one warp per keyframe slot k (the edge prev(k) -> k); a dead
//    slot returns at once and writes nothing. Lane d < 15 evaluates the
//    edge's residual on dual numbers seeded with the unit tangent of its
//    d-th local parameter [phi_g (2), log s, bg, ba, v_prev, v_k]
//    (dual.cuh), giving column d of its 9 x 15 Jacobian in shared memory;
//    the warp forms w J^T Omega J (15 x 15), w J^T Omega r (15) and
//    w r^T Omega r and writes them to scratch. Each block lets the
//    assembly launch start at once.
//  - Assembly: one thread per item (a 4-entry chunk of H, an entry of g,
//    the cost). Every block first lists the live slots in order and, for
//    each slot, the live edges that touch it (the weights, read from the
//    packed constants, and prev are inputs, not the edges' results); a thread whose chunk meets no live block writes
//    its zeros with one 16-byte store while the edges run and exits. The
//    others wait for the edge grid, then sum each entry's live edges'
//    terms in slot order: the 9 x 9 globals and the globals' rows over
//    every live edge, a velocity entry over the live edges at its slot
//    (an off-diagonal block only the edges that link its two slots), then
//    the bias priors. A slot may be the predecessor of any number of
//    edges, and an edge's two slots may be one. A dead slot's terms were
//    exact zeros that never changed a sum, so the sums are bit for bit
//    those over all K slots; two launches give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dual.cuh"

// per-slot constants, packed by optim/inertial.py:init_problem
#define C_DT 0
#define C_DR 1
#define C_DV 10
#define C_DP 13
#define C_JRG 16
#define C_JVG 25
#define C_JVA 34
#define C_JPG 43
#define C_JPA 52
#define C_BIAS0 61
#define C_INFO 67
#define C_W 148
#define N_C 149
#define G_ACC 9.81f

__device__ __forceinline__ Dl dexp1(Dl a) {
    const float e = expf(a.v);
    return Dl{e, e * a.d};
}

// optim/inertial.py:_edge_residuals for one slot at the local parameters
// (x's globals, v_prev, v_k) with tangent e_lane (lane >= 15: values only)
__device__ void init_residual(int lane, const float* x, const float* vp,
                              const float* vk, const float* C,
                              const float* Ri, const float* Rj,
                              const float* pi, const float* pj,
                              const float* base, int opt_scale, Dl* r) {
    Dl xl[15];
    for (int q = 0; q < 15; ++q) {
        const float v = q < 9 ? x[q] : (q < 12 ? vp[q - 9] : vk[q - 12]);
        xl[q] = Dl{v, q == lane ? 1.0f : 0.0f};
    }
    const Dl phi[3] = {xl[0], xl[1], dl(0.0f)};
    Dl E[9], B[9], Rwg[9], g[3];
    dexp(phi, E);
    for (int k = 0; k < 9; ++k) B[k] = dl(base[k]);
    dmm(E, B, Rwg);
    for (int i = 0; i < 3; ++i) g[i] = Rwg[3 * i + 2] * dl(-G_ACC);
    const Dl s = opt_scale ? dexp1(xl[2]) : dl(1.0f);
    Dl dbg[3], dba[3], u[3], J[9], dR[9], dRc[9], dVc[3], dPc[3];
    for (int q = 0; q < 3; ++q) {
        dbg[q] = xl[3 + q] - dl(C[C_BIAS0 + q]);
        dba[q] = xl[6 + q] - dl(C[C_BIAS0 + 3 + q]);
        dVc[q] = dl(C[C_DV + q]);
        dPc[q] = dl(C[C_DP + q]);
    }
    for (int k = 0; k < 9; ++k) {
        J[k] = dl(C[C_JRG + k]);
        dR[k] = dl(C[C_DR + k]);
    }
    dmv(J, dbg, u);
    dexp(u, E);
    dmm(dR, E, dRc);
    const int offs[4] = {C_JVG, C_JVA, C_JPG, C_JPA};
    for (int m = 0; m < 4; ++m) {
        for (int k = 0; k < 9; ++k) J[k] = dl(C[offs[m] + k]);
        dmv(J, (m % 2 == 0) ? dbg : dba, u);
        for (int q = 0; q < 3; ++q) {
            if (m < 2) dVc[q] = dVc[q] + u[q];
            else dPc[q] = dPc[q] + u[q];
        }
    }
    Dl RiT[9], M1[9], dRcT[9], M2[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            float m = 0.0f;
            for (int k = 0; k < 3; ++k) m += Ri[3 * k + i] * Rj[3 * k + j];
            M1[3 * i + j] = dl(m);
            RiT[3 * i + j] = dl(Ri[3 * j + i]);
        }
    dT(dRc, dRcT);
    dmm(dRcT, M1, M2);
    dlog(M2, r);
    const float dt = C[C_DT];
    Dl a[3], b[3], ra[3], rb[3];
    for (int q = 0; q < 3; ++q) {
        a[q] = xl[12 + q] - xl[9 + q] - g[q] * dl(dt);
        b[q] = dl(pj[q]) * s - dl(pi[q]) * s - xl[9 + q] * dl(dt) -
               (0.5f * g[q]) * dl(dt * dt);
    }
    dmv(RiT, a, ra);
    dmv(RiT, b, rb);
    for (int q = 0; q < 3; ++q) {
        r[3 + q] = ra[q] - dVc[q];
        r[6 + q] = rb[q] - dPc[q];
    }
}

__device__ __forceinline__ void griddep_launch_dependents() {
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void griddep_wait() {
    asm volatile("griddepcontrol.wait;" ::: "memory");
}

__global__ void __launch_bounds__(32)
init_edge_kernel(const float* __restrict__ cst, const float* __restrict__ Rwb,
                 const float* __restrict__ pwb, const float* __restrict__ x,
                 const float* __restrict__ base, const int* __restrict__ prev,
                 int opt_scale, float* __restrict__ He,
                 float* __restrict__ ge, float* __restrict__ ce) {
    griddep_launch_dependents();
    __shared__ float C[N_C];
    __shared__ float Je[9][15], JtW[9][15], re[9];
    const int e = blockIdx.x, lane = threadIdx.x;
    if (cst[(size_t)e * N_C + C_W] == 0.0f) return;
    for (int q = lane; q < N_C; q += 32) C[q] = cst[(size_t)e * N_C + q];
    __syncwarp();
    const float w = C[C_W];
    float* he = He + (size_t)e * 225;
    float* g = ge + (size_t)e * 15;
    const int p = max(prev[e], 0);
    if (lane < 15) {
        Dl r[9];
        init_residual(lane, x, x + 9 + 3 * p, x + 9 + 3 * e, C,
                      Rwb + 9 * (size_t)p, Rwb + 9 * (size_t)e,
                      pwb + 3 * (size_t)p, pwb + 3 * (size_t)e, base,
                      opt_scale, r);
        for (int a = 0; a < 9; ++a) Je[a][lane] = r[a].d;
        if (lane == 0)
            for (int a = 0; a < 9; ++a) re[a] = r[a].v;
    }
    __syncwarp();
    // JtW[b][i] = sum_a Je[a][i] Omega[a][b]
    for (int q = lane; q < 135; q += 32) {
        const int b = q / 15, i = q % 15;
        float s = 0.0f;
        for (int a = 0; a < 9; ++a) s += Je[a][i] * C[C_INFO + 9 * a + b];
        JtW[b][i] = s;
    }
    __syncwarp();
    for (int q = lane; q < 225; q += 32) {
        const int i = q / 15, j = q % 15;
        float s = 0.0f;
        for (int b = 0; b < 9; ++b) s += JtW[b][i] * Je[b][j];
        he[q] = w * s;
    }
    if (lane < 15) {
        float s = 0.0f;
        for (int b = 0; b < 9; ++b) s += JtW[b][lane] * re[b];
        g[lane] = w * s;
    }
    if (lane == 0) {
        float c = 0.0f;
        for (int i = 0; i < 9; ++i) {
            float s = 0.0f;
            for (int j = 0; j < 9; ++j) s += C[C_INFO + 9 * i + j] * re[j];
            c += re[i] * s;
        }
        ce[e] = w * c;
    }
}

// one edge's term of H at global rows / columns (r, c): the sum over the
// local places each parameter takes in that edge (a velocity slot may be
// both its v_prev and its v_k), rows outer, v_prev before v_k
__device__ __forceinline__ float edge_term(const float* he, int e, int p,
                                           int r, int c) {
    int r0 = -1, r1 = -1, c0 = -1, c1 = -1;
    if (r < 9) r0 = r;
    else {
        const int I = (r - 9) / 3, a = (r - 9) % 3;
        if (p == I) r0 = 9 + a;
        if (e == I) (r0 < 0 ? r0 : r1) = 12 + a;
    }
    if (c < 9) c0 = c;
    else {
        const int J = (c - 9) / 3, b = (c - 9) % 3;
        if (p == J) c0 = 9 + b;
        if (e == J) (c0 < 0 ? c0 : c1) = 12 + b;
    }
    float s = 0.0f;
    if (r0 >= 0 && c0 >= 0) s += he[r0 * 15 + c0];
    if (r0 >= 0 && c1 >= 0) s += he[r0 * 15 + c1];
    if (r1 >= 0 && c0 >= 0) s += he[r1 * 15 + c0];
    if (r1 >= 0 && c1 >= 0) s += he[r1 * 15 + c1];
    return s;
}

#define ASM_THREADS 256

__device__ __forceinline__ bool bit_of(const unsigned* m, int i) {
    return (m[i >> 5] >> (i & 31)) & 1u;
}

// the live edges, shared by an assembly block
struct Live {
    int n_live;
    const int* list;           // the live slots in slot order
    const int* sp;             // max(prev, 0) of every slot
    const unsigned* live;      // bit e: w_e != 0
    const unsigned* touched;   // bit s: a live edge has s as p or e
    const int* inc;            // slot s: its first two live edges in order
    const int* n_inc;          // slot s: how many live edges touch it
};

// whether H's entry (r, c) can be non-zero: a live edge touches both
__device__ __forceinline__ bool entry_live(const Live& L, int r, int c) {
    if (r < 9) return c < 9 || bit_of(L.touched, (c - 9) / 3);
    const int I = (r - 9) / 3;
    if (c < 9) return bit_of(L.touched, I);
    const int J = (c - 9) / 3;
    if (I == J) return bit_of(L.touched, I);
    return (bit_of(L.live, J) && L.sp[J] == I) ||
           (bit_of(L.live, I) && L.sp[I] == J);
}

// H's chunk q (flat entries 4q..4q+3, nH < 2^31) meets a live entry
__device__ __forceinline__ bool chunk_live(const Live& L, int q, int n,
                                           int nH) {
    const int f = 4 * q;
    int r = f / n, c = f - r * n;
    for (int t = 0; t < 4 && f + t < nH; ++t) {
        if (entry_live(L, r, c)) return true;
        if (++c == n) { c = 0; ++r; }
    }
    return false;
}

// the bias prior's weight on global parameter r < 9
__device__ __forceinline__ float prior_of(int r, float pg, float pa) {
    return r < 3 ? 0.0f : (r < 6 ? pg : pa);
}

// H's entry (r, c): its live edges' terms in slot order, then the prior
__device__ float h_entry(const Live& L, const float* __restrict__ He, int r,
                         int c, float pg, float pa) {
    float s = 0.0f;
    if (r >= 9 && c >= 9 && (r - 9) / 3 != (c - 9) / 3) {
        // two slots: only the edges from one to the other
        const int I = (r - 9) / 3, J = (c - 9) / 3;
        for (int t = 0; t < 2; ++t) {
            const int e = t == 0 ? min(I, J) : max(I, J);
            if (bit_of(L.live, e))
                s += edge_term(He + (size_t)e * 225, e, L.sp[e], r, c);
        }
    } else if (r < 9 && c < 9) {
        // the globals: every live edge
#pragma unroll 4
        for (int t = 0; t < L.n_live; ++t)
            s += 0.0f + He[(size_t)L.list[t] * 225 + r * 15 + c];
    } else {
        // the live edges at one slot
        const int S = r >= 9 ? (r - 9) / 3 : (c - 9) / 3;
        if (L.n_inc[S] <= 2) {
            for (int t = 0; t < L.n_inc[S]; ++t) {
                const int e = L.inc[2 * S + t];
                s += edge_term(He + (size_t)e * 225, e, L.sp[e], r, c);
            }
        } else {
            for (int t = 0; t < L.n_live; ++t) {
                const int e = L.list[t];
                if (e == S || L.sp[e] == S)
                    s += edge_term(He + (size_t)e * 225, e, L.sp[e], r, c);
            }
        }
    }
    if (r == c && r < 9) s += prior_of(r, pg, pa);
    return s;
}

__global__ void __launch_bounds__(ASM_THREADS)
init_assemble_kernel(int K, const float* __restrict__ cst,
                     const int* __restrict__ prev,
                     const float* __restrict__ He,
                     const float* __restrict__ ge,
                     const float* __restrict__ ce,
                     const float* __restrict__ x, float prior_gyro,
                     float prior_acc, float* __restrict__ H,
                     float* __restrict__ g, float* __restrict__ cost) {
    extern __shared__ int smem[];
    __shared__ int n_live;
    const int nw = (K + 31) >> 5, tid = threadIdx.x;
    int* sp = smem;
    int* list = smem + K;
    int* inc = list + K;
    int* n_inc = inc + 2 * K;
    unsigned* live = (unsigned*)(n_inc + K);
    unsigned* touched = live + nw;
    for (int q = tid; q < 2 * nw; q += ASM_THREADS) live[q] = 0u;
    __syncthreads();
    for (int e = tid; e < K; e += ASM_THREADS) {
        const int p = max(prev[e], 0);
        sp[e] = p;
        if (cst[(size_t)e * N_C + C_W] != 0.0f) {
            atomicOr(live + (e >> 5), 1u << (e & 31));
            atomicOr(touched + (e >> 5), 1u << (e & 31));
            atomicOr(touched + (p >> 5), 1u << (p & 31));
        }
    }
    __syncthreads();
    // the live slots in slot order: each one's rank among them
    for (int e = tid; e < K; e += ASM_THREADS) {
        const unsigned m = live[e >> 5];
        if (!((m >> (e & 31)) & 1u)) continue;
        int rank = __popc(m & ((1u << (e & 31)) - 1u));
        for (int wd = 0; wd < (e >> 5); ++wd) rank += __popc(live[wd]);
        list[rank] = e;
    }
    if (tid == 0) {
        int c = 0;
        for (int wd = 0; wd < nw; ++wd) c += __popc(live[wd]);
        n_live = c;
    }
    __syncthreads();
    // each touched slot's live edges in slot order (the first two kept)
    for (int S = tid; S < K; S += ASM_THREADS) {
        int c = 0;
        if (bit_of(touched, S))
            for (int t = 0; t < n_live; ++t) {
                const int e = list[t];
                if (e == S || sp[e] == S) {
                    if (c < 2) inc[2 * S + c] = e;
                    ++c;
                }
            }
        n_inc[S] = c;
    }
    __syncthreads();
    const Live L{n_live, list, sp, live, touched, inc, n_inc};
    const int n = 9 + 3 * K, nH = n * n, nq = (nH + 3) / 4;
    // one item a thread: H's 4-entry chunks, then g's entries, then the
    // cost. A chunk that meets no live entry gets zeros while the edges
    // run
    const int q = blockIdx.x * ASM_THREADS + tid;
    if (q >= nq + n + 1) return;
    if (q < nq && !chunk_live(L, q, n, nH)) {
        if (4 * q + 4 <= nH)
            reinterpret_cast<float4*>(H)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        else
            for (int f = 4 * q; f < nH; ++f) H[f] = 0.0f;
        return;
    }
    griddep_wait();
    if (q < nq) {
        const int f = 4 * q;
        int r = f / n, c = f - r * n;
        float v[4];
        for (int t = 0; t < 4; ++t) {
            v[t] = (f + t < nH && entry_live(L, r, c))
                       ? h_entry(L, He, r, c, prior_gyro, prior_acc)
                       : 0.0f;
            if (++c == n) { c = 0; ++r; }
        }
        if (f + 4 <= nH)
            reinterpret_cast<float4*>(H)[q] =
                make_float4(v[0], v[1], v[2], v[3]);
        else
            for (int t = 0; f + t < nH; ++t) H[f + t] = v[t];
    } else if (q < nq + n) {
        const int r = q - nq;
        float s = 0.0f;
        if (r < 9) {
#pragma unroll 4
            for (int t = 0; t < L.n_live; ++t)
                s += ge[(size_t)list[t] * 15 + r];
            s += prior_of(r, prior_gyro, prior_acc) * x[r];
        } else {
            const int I = (r - 9) / 3, a = (r - 9) % 3;
            const bool few = n_inc[I] <= 2;
            for (int t = 0; t < (few ? n_inc[I] : L.n_live); ++t) {
                const int e = few ? inc[2 * I + t] : list[t];
                const float* gg = ge + (size_t)e * 15;
                if (sp[e] == I) s += gg[9 + a];
                if (e == I) s += gg[12 + a];
            }
        }
        g[r] = s;
    } else {
        float s = 0.0f;
#pragma unroll 4
        for (int t = 0; t < L.n_live; ++t) s += ce[list[t]];
        for (int q2 = 3; q2 < 9; ++q2)
            s += prior_of(q2, prior_gyro, prior_acc) * x[q2] * x[q2];
        cost[0] = s;
    }
}

extern "C" int inertial_init_system(const void* cst, const void* Rwb,
                                    const void* pwb, const void* x,
                                    const void* base, const void* prev,
                                    int K, int opt_scale,
                                    float prior_gyro, float prior_acc,
                                    void* He, void* ge, void* ce, void* H,
                                    void* g, void* cost, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    init_edge_kernel<<<K, 32, 0, s>>>(
        (const float*)cst, (const float*)Rwb, (const float*)pwb,
        (const float*)x, (const float*)base, (const int*)prev, opt_scale,
        (float*)He, (float*)ge, (float*)ce);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    // items: n^2 / 4 chunks of H, n entries of g, the cost
    const long long n = 9 + 3LL * K, items = (n * n + 3) / 4 + n + 1;
    if (n * n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((items + ASM_THREADS - 1) / ASM_THREADS));
    cfg.blockDim = dim3(ASM_THREADS);
    cfg.dynamicSmemBytes = (size_t)(5 * K + 2 * ((K + 31) / 32)) * 4;
    cfg.stream = s;
    cudaLaunchAttribute at[1];
    at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    at[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
    rc = (int)cudaLaunchKernelEx(
        &cfg, init_assemble_kernel, K, (const float*)cst, (const int*)prev,
        (const float*)He, (const float*)ge, (const float*)ce,
        (const float*)x, prior_gyro, prior_acc, (float*)H, (float*)g,
        (float*)cost);
    if (rc) return rc;
    return (int)cudaGetLastError();
}
