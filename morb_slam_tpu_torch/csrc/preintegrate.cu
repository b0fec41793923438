// K11: IMU preintegration, the whole sample recursion of one call in one
// launch.
//
// Replaces morb_slam_tpu/imu.py:preintegrate (its lax.scan step), which the
// visual-inertial tracker runs on every frame (a 64-sample padded batch that
// extends the since-keyframe chain) and at every keyframe insert (a
// 768-sample padded buffer).
//
// What bounds it on an H100: latency. The call reads the mask of every slot
// (1 B), 28 B per valid sample and writes 1.2 KB; a valid sample needs 1,581
// float32 operations when the structure of A and B is used: 1,074 for the
// covariance (A C[:9,:9] 513, the upper blocks of (A C) A^T 369, B N B^T
// 180, the walk 12) and 507 for exp, the right Jacobian, the deltas, the
// bias Jacobians and the normalization (chip_smoke.py K11_FLOPS itemizes
// it). At 10-512 valid samples that is under 0.9 Mflop and 16 KB,
// nanoseconds against the card's rates. Each sample's
// state depends on the previous one's, so the chain of samples, each a few
// dependent steps, sets the time. The reference program issues that chain
// as one XLA loop; a plain PyTorch loop would issue ~60 small kernels per
// sample.
//
// Design: one warp, no block barrier (__syncwarp and shuffles only). The
// carry (dR, dV, dP, the 15x15 covariance, the five bias Jacobians, the
// sums of the measurements) lives in shared memory, dR in every lane's
// registers. Masked samples leave the carry unchanged, so they are
// skipped. The samples go in chunks of 32, four phases a chunk:
//  - Staging, a lane a sample: each valid sample's terms that do not
//    depend on the carry (a - b_a, hat(a), dt^2, so3_exp(w dt) and the
//    right Jacobian, the raw measurements) to shared memory; a ballot
//    gives the chunk's valid samples in order.
//  - The rotation chain, the same on every lane: each sample's old dR
//    staged, dR <- normalize(dR dRi), Gram-Schmidt with each
//    normalization's three divisions on three lanes at once.
//  - A lane a sample again: dR hat(a), dR a and the sample's blocks of A
//    (9x9) and B (9x6) from its old dR.
//  - The covariance, the bias Jacobians, dP and dV, sample by sample, two
//    __syncwarp a sample: lane l < 27 writes the entries (r, c) of
//    T = A C[:9,:9] for rows r = rb, rb + 3, rb + 6 (rb = l / 9, c = l %
//    9) and forms entry c of the Jacobians and row l % 3 of dP and dV
//    from the old values; after the first __syncwarp, C[:9,:9] = T A^T +
//    (B diag(N)) B^T at its three entries and the new carry. A and B are
//    I and 0 outside the sample's blocks; as a zero term never changes
//    these sums, each sums its non-zero terms alone, in index order.
//  - The chunk's sums in sample order (dt, the measurements, the random
//    walk's diagonal), a lane each.
// The sums run in index order, the plain version's association
// ((A C) A^T); results agree with it to float32 rounding. Every
// expression, and where a product is rounded before an addition,
// follows the serial form of the recursion (one thread doing each
// sample's whole update in turn), so the two forms give the same bits.
// The formulas (so3_exp, the right Jacobian, their |x| < 1e-4 series
// branches, the Gram-Schmidt normalization) are the port's lie.py /
// imu.py ones.
#include <cuda_runtime.h>
#include <stdint.h>

#define FULL 0xffffffffu
// packed output layout (imu.py _FIELDS)
#define O_DT 0
#define O_DR 1
#define O_DV 10
#define O_DP 13
#define O_C 16
#define O_JRG 241
#define O_JVG 250
#define O_JVA 259
#define O_JPG 268
#define O_JPA 277
#define O_AVGA 286
#define O_AVGW 289
#define O_BIAS 292
#define PACK 298
// a staged sample's terms (floats), the stride odd against bank conflicts
#define S_A 0      // a - b_a
#define S_WA 3     // hat(a)
#define S_DRI 12   // dRi = so3_exp(w dt)
#define S_JR 21    // its right Jacobian
#define S_DT 30
#define S_DT2 31
#define S_ACC 32   // the raw measurements
#define S_GYR 35
#define S_DRO 38   // dR before the sample
#define S_RA 47    // dR a
#define S_RWA 50   // dR hat(a)
#define S_A1 59    // A's block (3, 0): -dR hat(a) dt
#define S_A2 68    // A's block (6, 0): -dR hat(a) dt^2 / 2
#define S_B0 77    // B's block (0, 0): Jr dt
#define S_B1 86    // B's block (3, 3): dR dt
#define S_B2 95    // B's block (6, 3): dR dt^2 / 2
#define ST 105

__device__ float sinc_(float x) {
    return fabsf(x) < 1e-4f ? 1.0f - x * x / 6.0f : sinf(x) / x;
}
__device__ float cosc_(float x) {
    return fabsf(x) < 1e-4f ? 0.5f - x * x / 24.0f
                            : (1.0f - cosf(x)) / (x * x);
}
__device__ float sinc3_(float x) {
    return fabsf(x) < 1e-4f ? 1.0f / 6.0f - x * x / 120.0f
                            : (x - sinf(x)) / (x * x * x);
}

__device__ void hat(const float* w, float* W) {
    W[0] = 0.0f;  W[1] = -w[2]; W[2] = w[1];
    W[3] = w[2];  W[4] = 0.0f;  W[5] = -w[0];
    W[6] = -w[1]; W[7] = w[0];  W[8] = 0.0f;
}

// lie.so3_exp and lie.so3_right_jacobian of phi. The products phi_i phi_j
// are rounded before |phi|^2 sums them and hat(phi)^2 = phi phi^T -
// |phi|^2 I subtracts it: a compiler that shares each product between the
// two does so, and the right Jacobian's (1 - cos)/|phi|^2 magnifies any
// other rounding of |phi|
__device__ void exp_and_jr(const float* phi, float* R, float* Jr) {
    float P[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) P[3 * i + j] = __fmul_rn(phi[i], phi[j]);
    const float n2 = __fadd_rn(__fadd_rn(P[0], P[4]), P[8]);
    const float theta = sqrtf(n2 + 1e-24f);
    float W[9], W2[9], mphi[3] = {-phi[0], -phi[1], -phi[2]}, Wm[9];
    hat(phi, W);
    for (int k = 0; k < 9; ++k) W2[k] = k % 4 == 0 ? __fsub_rn(P[k], n2) : P[k];
    hat(mphi, Wm);
    const float a = sinc_(theta), b = cosc_(theta), c = sinc3_(theta);
    for (int k = 0; k < 9; ++k) {
        const float I = (k % 4 == 0) ? 1.0f : 0.0f;
        R[k] = I + a * W[k] + b * W2[k];
        Jr[k] = I + b * Wm[k] + c * W2[k];
    }
}

// x[t] for t in {0, 1, 2}, without a dynamic index
__device__ __forceinline__ float sel3(const float* x, int t) {
    return t == 0 ? x[0] : (t == 1 ? x[1] : x[2]);
}


// imu._normalize_rotation (Gram-Schmidt on the columns) on every lane of
// the warp, each of the two normalizations' three divisions on lanes 0-2
// at once. Rounding pinned as the serial form compiles: c1 - d r0 fused,
// each cross product's second term rounded and the first fused into it
__device__ void normalize_rotation(float* R, int lane) {
    const int t = lane % 3;
    float c0[3] = {R[0], R[3], R[6]}, c1[3] = {R[1], R[4], R[7]};
    const float n0 = sqrtf(c0[0] * c0[0] + c0[1] * c0[1] + c0[2] * c0[2]);
    float r0[3], r1[3], r2[3];
    const float q0 = sel3(c0, t) / n0;
    for (int i = 0; i < 3; ++i) r0[i] = __shfl_sync(FULL, q0, i);
    const float d = r0[0] * c1[0] + r0[1] * c1[1] + r0[2] * c1[2];
    for (int i = 0; i < 3; ++i) r1[i] = __fmaf_rn(-d, r0[i], c1[i]);
    const float n1 = sqrtf(r1[0] * r1[0] + r1[1] * r1[1] + r1[2] * r1[2]);
    const float q1 = sel3(r1, t) / n1;
    for (int i = 0; i < 3; ++i) r1[i] = __shfl_sync(FULL, q1, i);
    r2[0] = __fmaf_rn(r0[1], r1[2], -__fmul_rn(r0[2], r1[1]));
    r2[1] = __fmaf_rn(r0[2], r1[0], -__fmul_rn(r0[0], r1[2]));
    r2[2] = __fmaf_rn(r0[0], r1[1], -__fmul_rn(r0[1], r1[0]));
    for (int i = 0; i < 3; ++i) {
        R[3 * i] = r0[i];
        R[3 * i + 1] = r1[i];
        R[3 * i + 2] = r2[i];
    }
}

// C[:9, :9]'s new entry (r, c) = (T A^T)[r][c] + (B diag(N) B^T)[r][c]
// from T's row r, A's row c (its first block Ac, its entries c - 3 and c)
// and B's rows r and c in the block of columns they share (Br, Bc with
// the noise N there; meet false where they share none)
__device__ __forceinline__ float cov_entry(const float* Tr, int c, int ct,
                                           const float* Ac, float ac3,
                                           float ac, const float* Br,
                                           const float* N, bool meet,
                                           const float* Bc) {
    float s = 0.0f;
    s += Tr[0] * Ac[0];
    s += Tr[1] * Ac[1];
    s += Tr[2] * Ac[2];
    s += Tr[ct == 2 ? c - 3 : 0] * ac3;
    s += Tr[c] * ac;
    float u = 0.0f;
    for (int k = 0; k < 3; ++k) u += (Br[k] * N[k]) * (meet ? Bc[k] : 0.0f);
    return s + u;
}

__global__ void __launch_bounds__(32)
preintegrate_kernel(const float* __restrict__ acc,
                    const float* __restrict__ gyro,
                    const float* __restrict__ dts,
                    const uint8_t* __restrict__ mask,
                    const float* __restrict__ bias,
                    const float* __restrict__ cov,
                    const float* __restrict__ cov_walk,
                    const float* __restrict__ init, int N,
                    float* __restrict__ out) {
    __shared__ float S[PACK];      // the carry, in the packed layout
    __shared__ float st[32 * ST];  // one chunk's staged samples
    __shared__ float T[81];
    const int lane = threadIdx.x;
    for (int k = lane; k < PACK; k += 32) {
        float v;
        if (k >= O_BIAS) {
            v = bias[k - O_BIAS];
        } else if (init) {
            v = init[k];
        } else {
            v = 0.0f;
            if (k == O_DR || k == O_DR + 4 || k == O_DR + 8) v = 1.0f;
        }
        S[k] = v;
    }
    float cv[6];
    for (int q = 0; q < 6; ++q) cv[q] = cov[q];
    float n_s = init ? 1.0f : 0.0f;   // the averages' count
    // lane l < 27 owns the covariance entries (rb + 3j, c), j = 0..2, and
    // entry c of the bias Jacobians (lanes 9-26 repeat lanes 0-8's and
    // lanes 27-31 lane 26's work, storing nothing); lane q < 3 row q of
    // dP and dV
    const int l = min(lane, 26), c = l % 9, rb = l / 9;
    const int ct = c / 3, ci = c % 3, q3 = lane % 3;
    const bool own = lane < 27;
    // the chunk sums' lanes: 0 dt, 1-3 the accelerations, 4-6 the rates,
    // 7-12 the random-walk diagonal (weight 1, or the walk's variance)
    const int so = lane == 0 ? O_DT
                   : (lane < 4 ? O_AVGA + lane - 1
                      : (lane < 7 ? O_AVGW + lane - 4
                         : O_C + 16 * (lane - 7) + 144));
    const int sf = lane == 0 ? S_DT
                   : (lane < 4 ? S_ACC + lane - 1
                      : (lane < 7 ? S_GYR + lane - 4 : S_DT));
    const float sw = lane < 7 ? 1.0f : cov_walk[lane < 13 ? lane - 7 : 0];
    __syncwarp();
    float dR[9];                      // the carry's dR, on every lane
    for (int k = 0; k < 9; ++k) dR[k] = S[O_DR + k];

    for (int base = 0; base < N; base += 32) {
        // staging: a lane a sample
        const int i = base + lane;
        const bool valid = i < N && mask[i];
        float* me = st + lane * ST;
        if (valid) {
            const float dt = dts[i];
            const float dt2 = dt * dt;
            float a[3], w[3], phi[3], dRi[9], Jr[9], Wa[9];
            for (int q = 0; q < 3; ++q) {
                a[q] = acc[3 * i + q] - bias[3 + q];
                w[q] = gyro[3 * i + q] - bias[q];
                phi[q] = w[q] * dt;
                me[S_A + q] = a[q];
                me[S_ACC + q] = acc[3 * i + q];
                me[S_GYR + q] = gyro[3 * i + q];
            }
            hat(a, Wa);
            exp_and_jr(phi, dRi, Jr);
            for (int k = 0; k < 9; ++k) {
                me[S_WA + k] = Wa[k];
                me[S_DRI + k] = dRi[k];
                me[S_JR + k] = Jr[k];
            }
            me[S_DT] = dt;
            me[S_DT2] = dt2;
        }
        const unsigned vm = __ballot_sync(FULL, valid);
        __syncwarp();
        // the rotation chain, on every lane: each sample's old dR staged,
        // dR <- normalize(dR dRi)
        for (unsigned m = vm; m; m &= m - 1) {
            float* sm = st + (__ffs(m) - 1) * ST;
            float dRi[9], Rn[9];
            for (int k = 0; k < 9; ++k) {
                dRi[k] = sm[S_DRI + k];
                if (lane == k) sm[S_DRO + k] = dR[k];
            }
            for (int r = 0; r < 3; ++r)
                for (int k = 0; k < 3; ++k)
                    Rn[3 * r + k] = dR[3 * r] * dRi[k] +
                                    dR[3 * r + 1] * dRi[3 + k] +
                                    dR[3 * r + 2] * dRi[6 + k];
            normalize_rotation(Rn, lane);
            for (int k = 0; k < 9; ++k) dR[k] = Rn[k];
        }
        __syncwarp();
        // a lane a sample: dR hat(a), dR a and the sample's blocks of
        // imu.py's A (9x9) and B (9x6), from its old dR
        if (valid) {
            const float dt = me[S_DT], dt2 = me[S_DT2];
            float R[9], Wa[9];
            for (int k = 0; k < 9; ++k) {
                R[k] = me[S_DRO + k];
                Wa[k] = me[S_WA + k];
            }
            for (int r = 0; r < 3; ++r) {
                me[S_RA + r] = R[3 * r] * me[S_A] + R[3 * r + 1] * me[S_A + 1] +
                               R[3 * r + 2] * me[S_A + 2];
                for (int k = 0; k < 3; ++k) {
                    const int e = 3 * r + k;
                    const float v = R[3 * r] * Wa[k] + R[3 * r + 1] * Wa[3 + k] +
                                    R[3 * r + 2] * Wa[6 + k];
                    me[S_RWA + e] = v;
                    me[S_A1 + e] = -v * dt;
                    me[S_A2 + e] = -0.5f * v * dt2;
                    me[S_B0 + e] = me[S_JR + e] * dt;
                    me[S_B1 + e] = R[e] * dt;
                    me[S_B2 + e] = 0.5f * R[e] * dt2;
                }
            }
        }
        __syncwarp();
        // the covariance and the bias Jacobians, sample by sample. A and
        // B are I and 0 outside the sample's blocks: row r < 3 of A is
        // [dRi^T row r, 0, 0], row 3 + r [A1 row r, e_r, 0], row 6 + r
        // [A2 row r, dt e_r, e_r]; row r of B is [B0 row r, 0], row 3 + r
        // [0, B1 row r], row 6 + r [0, B2 row r]. A zero term never
        // changes a sum here (the sums start at +0 and the covariance is
        // finite), so the sums take the non-zero terms alone, in index
        // order: the bits of the dense products.
        for (unsigned m = vm; m; m &= m - 1) {
            const float* sm = st + (__ffs(m) - 1) * ST;
            const float dt = sm[S_DT], dt2 = sm[S_DT2];
            float A0[3], A1[3], A2[3], B0[3], B1[3], B2[3], Ac[3], Bc[3];
            const float* ac = ct == 0 ? sm + S_DRI + ci
                                      : sm + (ct == 1 ? S_A1 : S_A2) + 3 * ci;
            const int as = ct == 0 ? 3 : 1;
            const float* bc = sm + (ct == 0 ? S_B0 : (ct == 1 ? S_B1 : S_B2)) +
                              3 * ci;
            for (int k = 0; k < 3; ++k) {
                A0[k] = sm[S_DRI + 3 * k + rb];
                A1[k] = sm[S_A1 + 3 * rb + k];
                A2[k] = sm[S_A2 + 3 * rb + k];
                B0[k] = sm[S_B0 + 3 * rb + k];
                B1[k] = sm[S_B1 + 3 * rb + k];
                B2[k] = sm[S_B2 + 3 * rb + k];
                Ac[k] = ac[as * k];
                Bc[k] = bc[k];
            }
            const float ac3 = ct == 2 ? dt : 0.0f;     // A[c][c - 3]
            const float acd = ct > 0 ? 1.0f : 0.0f;    // A[c][c]
            // T = A C[:9, :9] at (rb + 3j, c)
            {
                const float* Cc = S + O_C + c;
                const float C0 = Cc[0], C1 = Cc[15], C2 = Cc[30];
                const float C3 = Cc[15 * (rb + 3)], C6 = Cc[15 * (rb + 6)];
                float t0 = 0.0f, t1 = 0.0f, t2 = 0.0f;
                t0 += A0[0] * C0;
                t0 += A0[1] * C1;
                t0 += A0[2] * C2;
                t1 += A1[0] * C0;
                t1 += A1[1] * C1;
                t1 += A1[2] * C2;
                t1 += C3;
                t2 += A2[0] * C0;
                t2 += A2[1] * C1;
                t2 += A2[2] * C2;
                t2 += dt * C3;
                t2 += C6;
                if (own) {
                    T[9 * rb + c] = t0;
                    T[9 * (rb + 3) + c] = t1;
                    T[9 * (rb + 6) + c] = t2;
                }
            }
            // the bias Jacobians' entry c from the old values: the
            // products that are B's entries (Jr dt, dR dt, dR dt^2 / 2)
            // subtracted as rounded, dR hat(a) J_Rg's fused
            float nJ[5];
            {
                const float* JRg = S + O_JRG;
                const float* u = sm + S_RWA + 3 * ct;
                const float RWaJ = u[0] * JRg[ci] + u[1] * JRg[3 + ci] +
                                   u[2] * JRg[6 + ci];
                const float RiJ = sm[S_DRI + ct] * JRg[ci] +
                                  sm[S_DRI + 3 + ct] * JRg[3 + ci] +
                                  sm[S_DRI + 6 + ct] * JRg[6 + ci];
                const float JVg = S[O_JVG + c], JVa = S[O_JVA + c];
                nJ[0] = S[O_JPA + c] + JVa * dt - sm[S_B2 + c];
                nJ[1] = __fmaf_rn(-(0.5f * RWaJ), dt2,
                                  S[O_JPG + c] + JVg * dt);
                nJ[2] = JVa - sm[S_B1 + c];
                nJ[3] = __fmaf_rn(-RWaJ, dt, JVg);
                nJ[4] = RiJ - sm[S_B0 + c];
            }
            // dP and dV row q3
            const float Ra = sm[S_RA + q3];
            const float dV = S[O_DV + q3];
            const float nP = S[O_DP + q3] + dV * dt + 0.5f * Ra * dt2;
            const float nV = dV + Ra * dt;
            __syncwarp();
            // C[:9, :9] = T A^T + (B N) B^T at (rb + 3j, c)
            if (own) {
                const float* Tr = T + 9 * rb;
                S[O_C + 15 * rb + c] =
                    cov_entry(Tr, c, ct, Ac, ac3, acd, B0, cv, ct == 0, Bc);
                S[O_C + 15 * (rb + 3) + c] = cov_entry(
                    Tr + 27, c, ct, Ac, ac3, acd, B1, cv + 3, ct > 0, Bc);
                S[O_C + 15 * (rb + 6) + c] = cov_entry(
                    Tr + 54, c, ct, Ac, ac3, acd, B2, cv + 3, ct > 0, Bc);
            }
            if (lane < 9) {
                S[O_JPA + c] = nJ[0];
                S[O_JPG + c] = nJ[1];
                S[O_JVA + c] = nJ[2];
                S[O_JVG + c] = nJ[3];
                S[O_JRG + c] = nJ[4];
            }
            if (lane < 3) {
                S[O_DP + q3] = nP;
                S[O_DV + q3] = nV;
            }
            __syncwarp();
        }
        // the chunk's sums in sample order (x + y as fma(1, y, x))
        if (lane < 13) {
            float x = S[so];
            for (int j = 0; j < 32; ++j)
                if ((vm >> j) & 1u) x = fmaf(sw, st[j * ST + sf], x);
            S[so] = x;
        }
        n_s += (float)__popc(vm);
        __syncwarp();
    }
    for (int k = 0; k < 9; ++k)
        if (lane == k) S[O_DR + k] = dR[k];
    __syncwarp();
    const float n = fmaxf(n_s, 1.0f);
    for (int k = lane; k < PACK; k += 32) {
        float v = S[k];
        if (k >= O_AVGA && k < O_BIAS) v = v / n;
        out[k] = v;
    }
}

extern "C" int preintegrate(const void* acc, const void* gyro,
                            const void* dts, const void* mask,
                            const void* bias, const void* cov,
                            const void* cov_walk, const void* init, int N,
                            void* out, void* stream) {
    preintegrate_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
        (const float*)acc, (const float*)gyro, (const float*)dts,
        (const uint8_t*)mask, (const float*)bias, (const float*)cov,
        (const float*)cov_walk, (const float*)init, N, (float*)out);
    return (int)cudaGetLastError();
}
