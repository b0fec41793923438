// K15: the edge terms and dense normal equations of one Gauss-Newton
// iteration of the Sim(3) / 4-DoF essential-graph optimization.
//
// Replaces the body of morb_slam_tpu/optim/pose_graph.py:optimize (:80):
// per edge the 7-dof residual `_edge_residual` (:53) and its 7 x 14
// Jacobian at zero tangent (vmap(jacfwd)), camera side (Sim(3), fix_scale)
// or world side (four_dof); the (i,i), (j,j), (i,j), (j,i) blocks of
// J^T w J scattered into the dense (7K)^2 matrix, the gradient and the cost
// sum w |r|^2 before the step. The plain version is
// optim/pose_graph.py:normal_equations_plain; the free-mask and 4-DoF mask
// products, the Cholesky solve and the Sim(3) update stay in torch.
//
// What bounds it on an H100: bytes. The dense H is (7K)^2 floats, 51 MB at
// K = 512, zero-filled and then written where blocks are touched; the
// edges read ~100 B each, and the Jacobians are ~14 x 700 flops per edge
// (a few Mflop for the loop path's graph). The fill, 15 us at 3.35 TB/s,
// is the bound; the edge Jacobians' dual-number chain is the latency.
//
// Design: one call, five steps on the stream, no float atomics, no host
// synchronisation.
//  - Zero fill of H and b (cudaMemsetAsync).
//  - Edges: one warp per edge of nonzero weight (the list comes from the
//    block order, computed once per optimize call: the graph's topology is
//    fixed across its iterations). Lane d < 14 evaluates the residual on
//    dual numbers seeded with the unit tangent e_d: sim3_exp at zero
//    (exp(sigma) = 1, so3_exp = I and W = I, with their derivatives), two
//    sim3_mul, sim3_inv, sim3_mul and sim3_log, whose V^-1 t is a
//    closed-form 3 x 3 solve (adjugate over determinant) and whose W keeps
//    lie.py's branches for small sigma and small theta. The warp writes
//    J (7 x 14) and r (7) to scratch.
//  - Assembly: the contributions (edge, kind in ii / jj / ij / ji) sorted
//    by target block once per call; one warp per touched 7 x 7 block sums
//    its contributions in that order (the plain version's order: kind,
//    then edge), two entries per lane; the warp of a diagonal block also
//    sums the node's gradient from its ii and jj contributions.
//  - Cost: one block; thread t sums the edges t, t + 1024, ..., then a
//    fixed shared-memory tree reduces the threads.
// Two launches give the same bits. An edge of weight 0 contributes zero to
// H, b and the cost in the plain version too; it is left out of the lists.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dual.cuh"

#define EDGE_WARPS 4
#define BLK_WARPS 4
#define COST_THREADS 1024

__device__ __forceinline__ Dl dexpf_(Dl a) {
    const float e = expf(a.v);
    return Dl{e, e * a.d};
}
__device__ __forceinline__ Dl dlogf_(Dl a) {
    return Dl{logf(a.v), a.d / a.v};
}
// lie.py _sinc3 with its |x| < 1e-4 series branch
__device__ Dl dsinc3(Dl x) {
    if (fabsf(x.v) < 1e-4f)
        return dl(1.0f / 6.0f) - (1.0f / 120.0f) * (x * x);
    return (x - dsin(x)) / (x * x * x);
}

// a Sim(3) element on dual numbers
struct DSim3 {
    Dl s, R[9], t[3];
};

// (sa, Ra, ta)(sb, Rb, tb) = (sa sb, Ra Rb, sa Ra tb + ta)
__device__ void dsim3_mul(const DSim3& a, const DSim3& b, DSim3& c) {
    c.s = a.s * b.s;
    dmm(a.R, b.R, c.R);
    Dl u[3];
    dmv(a.R, b.t, u);
    for (int q = 0; q < 3; ++q) c.t[q] = a.s * u[q] + a.t[q];
}

__device__ void dsim3_inv(const DSim3& a, DSim3& b) {
    b.s = dl(1.0f) / a.s;
    dT(a.R, b.R);
    Dl u[3];
    dmv(b.R, a.t, u);
    for (int q = 0; q < 3; ++q) b.t[q] = -(b.s * u[q]);
}

// lie._sim3_W(theta, sigma, phi)
__device__ void dsim3_W(Dl theta, Dl sigma, const Dl* phi, Dl* W) {
    const Dl s = dexpf_(sigma);
    const bool small_sig = fabsf(sigma.v) < 1e-5f;
    const bool small_th = theta.v < 1e-5f;
    const Dl C = small_sig
        ? dl(1.0f) + (1.0f / 2.0f) * sigma + (1.0f / 6.0f) * (sigma * sigma)
        : (s - dl(1.0f)) / sigma;
    Dl A, B;
    if (small_th) {
        const Dl sig2 = sigma * sigma;
        A = small_sig ? dl(0.5f) + (1.0f / 6.0f) * sigma
                      : ((sigma - dl(1.0f)) * s + dl(1.0f)) / sig2;
        B = small_sig ? dl(1.0f / 6.0f) + (1.0f / 24.0f) * sigma
                      : (s * dl(0.5f) * sig2 + s - dl(1.0f) - sigma * s) /
                            (sig2 * sigma);
    } else if (small_sig) {
        A = dcosc(theta);
        B = dsinc3(theta);
    } else {
        const Dl a = s * dsin(theta), b = s * dcos(theta);
        const Dl th2 = theta * theta, sig2 = sigma * sigma;
        const Dl denom = sig2 + th2;
        A = (a * sigma + (dl(1.0f) - b) * theta) / (theta * denom);
        B = (C - ((b - dl(1.0f)) * sigma + a * theta) / denom) / th2;
    }
    Dl P[9];
    dhat(phi, P);
    const Dl n2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            const Dl P2 = phi[i] * phi[j] - (i == j ? n2 : dl(0.0f));
            W[3 * i + j] = (i == j ? C : dl(0.0f)) + A * P[3 * i + j] +
                           B * P2;
        }
}

// lie.sim3_log: [rho, phi, sigma] with rho = W^-1 t by the adjugate
__device__ void dsim3_log(const DSim3& a, Dl* out) {
    const Dl sigma = dlogf_(a.s);
    Dl phi[3];
    dlog(a.R, phi);
    const Dl theta = dsqrt(phi[0] * phi[0] + phi[1] * phi[1] +
                           phi[2] * phi[2] + dl(1e-24f));
    Dl W[9];
    dsim3_W(theta, sigma, phi, W);
    Dl adj[9];
    adj[0] = W[4] * W[8] - W[5] * W[7];
    adj[1] = W[2] * W[7] - W[1] * W[8];
    adj[2] = W[1] * W[5] - W[2] * W[4];
    adj[3] = W[5] * W[6] - W[3] * W[8];
    adj[4] = W[0] * W[8] - W[2] * W[6];
    adj[5] = W[2] * W[3] - W[0] * W[5];
    adj[6] = W[3] * W[7] - W[4] * W[6];
    adj[7] = W[1] * W[6] - W[0] * W[7];
    adj[8] = W[0] * W[4] - W[1] * W[3];
    const Dl det = W[0] * adj[0] + W[1] * adj[3] + W[2] * adj[6];
    Dl u[3];
    dmv(adj, a.t, u);
    for (int q = 0; q < 3; ++q) out[q] = u[q] / det;
    for (int q = 0; q < 3; ++q) out[3 + q] = phi[q];
    out[6] = sigma;
}

__device__ void load_sim3(DSim3& a, const float* s, const float* R,
                          const float* t, int k) {
    a.s = dl(s[k]);
    for (int q = 0; q < 9; ++q) a.R[q] = dl(R[(size_t)k * 9 + q]);
    for (int q = 0; q < 3; ++q) a.t[q] = dl(t[(size_t)k * 3 + q]);
}

// exp of the tangent seeded at lane - off (zero tangent): (1, I, 0) with
// the unit derivative in sigma, phi or rho
__device__ void seed_exp(DSim3& a, int lane, int off) {
    const int d = lane - off;
    a.s = Dl{1.0f, d == 6 ? 1.0f : 0.0f};
    for (int q = 0; q < 9; ++q) a.R[q] = dl((q % 4 == 0) ? 1.0f : 0.0f);
    if (d >= 3 && d < 6) {       // hat(e_{d-3})
        const int k = d - 3;
        const int i1 = (k + 1) % 3, i2 = (k + 2) % 3;
        a.R[3 * i2 + i1].d = 1.0f;
        a.R[3 * i1 + i2].d = -1.0f;
    }
    for (int q = 0; q < 3; ++q) a.t[q] = Dl{0.0f, d == q ? 1.0f : 0.0f};
}

__global__ void __launch_bounds__(32 * EDGE_WARPS)
pg_edge_kernel(int n, const int* __restrict__ edges,
               const int* __restrict__ ei, const int* __restrict__ ej,
               const float* __restrict__ s, const float* __restrict__ R,
               const float* __restrict__ t, const float* __restrict__ es,
               const float* __restrict__ eR, const float* __restrict__ et,
               int world_side, float* __restrict__ J,
               float* __restrict__ r) {
    const int k = blockIdx.x * EDGE_WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (k >= n || lane >= 14) return;
    const int e = edges[k];
    // a = S_jw' and b = S_iw' (the perturbed nodes), c = S_ij a,
    // d = c b^-1; four buffers, reused as their values die
    DSim3 A, B, C, D;
    load_sim3(A, s, R, t, ej[e]);
    seed_exp(B, lane, 7);
    if (world_side) dsim3_mul(A, B, C);
    else dsim3_mul(B, A, C);                       // C = a
    load_sim3(A, es, eR, et, e);
    dsim3_mul(A, C, B);                            // B = c
    load_sim3(A, s, R, t, ei[e]);
    seed_exp(C, lane, 0);
    if (world_side) dsim3_mul(A, C, D);
    else dsim3_mul(C, A, D);                       // D = b
    dsim3_inv(D, A);
    dsim3_mul(B, A, C);                            // C = d
    Dl out[7];
    dsim3_log(C, out);
    for (int q = 0; q < 7; ++q) J[(size_t)e * 98 + q * 14 + lane] = out[q].d;
    if (lane == 0)
        for (int q = 0; q < 7; ++q) r[(size_t)e * 7 + q] = out[q].v;
}

__global__ void __launch_bounds__(32 * BLK_WARPS)
pg_block_kernel(int nb, int K, const int* __restrict__ blk_row,
                const int* __restrict__ blk_col,
                const int* __restrict__ blk_start,
                const int* __restrict__ con_edge,
                const int* __restrict__ con_kind,
                const float* __restrict__ w, const float* __restrict__ J,
                const float* __restrict__ r, float* __restrict__ H,
                float* __restrict__ b) {
    const int k = blockIdx.x * BLK_WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (k >= nb) return;
    const int row = blk_row[k], col = blk_col[k];
    const int c0 = blk_start[k], c1 = blk_start[k + 1];
    const size_t D = 7 * (size_t)K;
    for (int q = lane; q < 49; q += 32) {
        const int i = q / 7, j = q % 7;
        float acc = 0.0f;
        for (int c = c0; c < c1; ++c) {
            const int e = con_edge[c], kind = con_kind[c];
            // kind 0: (i,i) Ji Ji, 1: (j,j) Jj Jj, 2: (i,j) Ji Jj, 3: (j,i)
            const int oa = (kind == 1 || kind == 3) ? 7 : 0;
            const int ob = (kind == 1 || kind == 2) ? 7 : 0;
            const float* Je = J + (size_t)e * 98;
            const float we = w[e];
            float blk = 0.0f;
            for (int a = 0; a < 7; ++a)
                blk += (Je[a * 14 + oa + i] * we) * Je[a * 14 + ob + j];
            acc += blk;
        }
        H[(7 * (size_t)row + i) * D + 7 * (size_t)col + j] = acc;
    }
    if (row == col && lane < 7) {
        float acc = 0.0f;
        for (int c = c0; c < c1; ++c) {
            const int kind = con_kind[c];
            if (kind > 1) continue;
            const int e = con_edge[c];
            const int oa = kind == 1 ? 7 : 0;
            const float* Je = J + (size_t)e * 98;
            const float we = w[e];
            float g = 0.0f;
            for (int a = 0; a < 7; ++a)
                g += (Je[a * 14 + oa + lane] * we) * r[(size_t)e * 7 + a];
            acc += g;
        }
        b[7 * row + lane] = -acc;
    }
}

__global__ void __launch_bounds__(COST_THREADS)
pg_cost_kernel(int n, const int* __restrict__ edges,
               const float* __restrict__ w, const float* __restrict__ r,
               float* __restrict__ out) {
    __shared__ float red[COST_THREADS];
    const int tid = threadIdx.x;
    float acc = 0.0f;
    for (int k = tid; k < n; k += COST_THREADS) {
        const int e = edges[k];
        float s = 0.0f;
        for (int q = 0; q < 7; ++q) s += r[(size_t)e * 7 + q] * r[(size_t)e * 7 + q];
        acc += w[e] * s;
    }
    red[tid] = acc;
    __syncthreads();
    for (int h = COST_THREADS / 2; h > 0; h >>= 1) {
        if (tid < h) red[tid] += red[tid + h];
        __syncthreads();
    }
    if (tid == 0) out[0] = red[0];
}

extern "C" int pose_graph_normal(
    int K, int n, const void* edges, const void* ei, const void* ej,
    const void* s, const void* R, const void* t, const void* es,
    const void* eR, const void* et, const void* w, int world_side, int nb,
    const void* blk_row, const void* blk_col, const void* blk_start,
    const void* con_edge, const void* con_kind, void* J, void* r, void* H,
    void* b, void* cost, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const size_t D = 7 * (size_t)K;
    int rc = (int)cudaMemsetAsync(H, 0, D * D * sizeof(float), st);
    if (rc) return rc;
    rc = (int)cudaMemsetAsync(b, 0, D * sizeof(float), st);
    if (rc) return rc;
    if (n > 0) {
        pg_edge_kernel<<<(n + EDGE_WARPS - 1) / EDGE_WARPS, 32 * EDGE_WARPS,
                         0, st>>>(
            n, (const int*)edges, (const int*)ei, (const int*)ej,
            (const float*)s, (const float*)R, (const float*)t,
            (const float*)es, (const float*)eR, (const float*)et, world_side,
            (float*)J, (float*)r);
        rc = (int)cudaGetLastError();
        if (rc) return rc;
    }
    if (nb > 0) {
        pg_block_kernel<<<(nb + BLK_WARPS - 1) / BLK_WARPS, 32 * BLK_WARPS,
                          0, st>>>(
            nb, K, (const int*)blk_row, (const int*)blk_col,
            (const int*)blk_start, (const int*)con_edge,
            (const int*)con_kind, (const float*)w, (const float*)J,
            (const float*)r, (float*)H, (float*)b);
        rc = (int)cudaGetLastError();
        if (rc) return rc;
    }
    pg_cost_kernel<<<1, COST_THREADS, 0, st>>>(
        n, (const int*)edges, (const float*)w, (const float*)r,
        (float*)cost);
    return (int)cudaGetLastError();
}
