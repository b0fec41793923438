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
// Design: one block of 96 threads. The carry (dR, dV, dP, the 15x15
// covariance, the five bias Jacobians, the sums of the measurements) lives
// in shared memory. Masked samples leave the carry unchanged, so they are
// skipped; every thread reads the same mask entry, so the skip is uniform.
// Per valid sample: thread 0 builds the transition blocks A (9x9) and B
// (9x6) from the old carry, then updates dP, dV, the Jacobians and dR
// (Gram-Schmidt re-normalized) in place; after a barrier 81 threads form
// T = A C[:9,:9] one entry each, and after a second barrier
// C[:9,:9] = T A^T + (B diag(N)) B^T, while 6 threads add the random-walk
// diagonal. The sums over k run in index order, the plain version's
// association ((A C) A^T); results agree to float32 rounding. The formulas
// (so3_exp, the right Jacobian, their |x| < 1e-4 series branches, the
// Gram-Schmidt normalization) are the port's lie.py / imu.py ones.
#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 96
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

// hat(w)^2 = w w^T - |w|^2 I
__device__ void hat_sq(const float* w, float* W2) {
    const float n2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            W2[3 * i + j] = w[i] * w[j] - (i == j ? n2 : 0.0f);
}

__device__ void mm3(const float* A, const float* B, float* C) {
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                           A[3 * i + 2] * B[6 + j];
}

// lie.so3_exp and lie.so3_right_jacobian of phi
__device__ void exp_and_jr(const float* phi, float* R, float* Jr) {
    const float n2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
    const float theta = sqrtf(n2 + 1e-24f);
    float W[9], W2[9], mphi[3] = {-phi[0], -phi[1], -phi[2]}, Wm[9];
    hat(phi, W);
    hat_sq(phi, W2);
    hat(mphi, Wm);
    const float a = sinc_(theta), b = cosc_(theta), c = sinc3_(theta);
    for (int k = 0; k < 9; ++k) {
        const float I = (k % 4 == 0) ? 1.0f : 0.0f;
        R[k] = I + a * W[k] + b * W2[k];
        Jr[k] = I + b * Wm[k] + c * W2[k];
    }
}

// imu._normalize_rotation: Gram-Schmidt on the columns
__device__ void normalize_rotation(float* R) {
    float c0[3] = {R[0], R[3], R[6]}, c1[3] = {R[1], R[4], R[7]};
    const float n0 = sqrtf(c0[0] * c0[0] + c0[1] * c0[1] + c0[2] * c0[2]);
    float r0[3], r1[3], r2[3];
    for (int i = 0; i < 3; ++i) r0[i] = c0[i] / n0;
    const float d = r0[0] * c1[0] + r0[1] * c1[1] + r0[2] * c1[2];
    for (int i = 0; i < 3; ++i) r1[i] = c1[i] - d * r0[i];
    const float n1 = sqrtf(r1[0] * r1[0] + r1[1] * r1[1] + r1[2] * r1[2]);
    for (int i = 0; i < 3; ++i) r1[i] = r1[i] / n1;
    r2[0] = r0[1] * r1[2] - r0[2] * r1[1];
    r2[1] = r0[2] * r1[0] - r0[0] * r1[2];
    r2[2] = r0[0] * r1[1] - r0[1] * r1[0];
    for (int i = 0; i < 3; ++i) {
        R[3 * i] = r0[i];
        R[3 * i + 1] = r1[i];
        R[3 * i + 2] = r2[i];
    }
}

__global__ void __launch_bounds__(THREADS)
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
    __shared__ float A[81], B[54], T[81];
    __shared__ float n_s;
    const int tid = threadIdx.x;
    for (int k = tid; k < PACK; k += THREADS) {
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
    if (tid == 0) n_s = init ? 1.0f : 0.0f;   // the averages' count
    __syncthreads();

    for (int i = 0; i < N; ++i) {
        if (!mask[i]) continue;
        const float dt = dts[i];
        if (tid == 0) {
            const float dt2 = dt * dt;
            float a[3], w[3], phi[3];
            for (int q = 0; q < 3; ++q) {
                a[q] = acc[3 * i + q] - bias[3 + q];
                w[q] = gyro[3 * i + q] - bias[q];
                phi[q] = w[q] * dt;
            }
            float dR[9], Wa[9], RWa[9], dRi[9], Jr[9], Ra[3];
            for (int k = 0; k < 9; ++k) dR[k] = S[O_DR + k];
            hat(a, Wa);
            mm3(dR, Wa, RWa);
            exp_and_jr(phi, dRi, Jr);
            for (int r = 0; r < 3; ++r)
                Ra[r] = dR[3 * r] * a[0] + dR[3 * r + 1] * a[1] +
                        dR[3 * r + 2] * a[2];
            // transition blocks from the old carry (imu.py A, B)
            for (int k = 0; k < 81; ++k) A[k] = (k % 10 == 0) ? 1.0f : 0.0f;
            for (int k = 0; k < 54; ++k) B[k] = 0.0f;
            for (int r = 0; r < 3; ++r)
                for (int c = 0; c < 3; ++c) {
                    A[9 * r + c] = dRi[3 * c + r];
                    A[9 * (3 + r) + c] = -RWa[3 * r + c] * dt;
                    A[9 * (6 + r) + c] = -0.5f * RWa[3 * r + c] * dt2;
                    B[6 * r + c] = Jr[3 * r + c] * dt;
                    B[6 * (3 + r) + 3 + c] = dR[3 * r + c] * dt;
                    B[6 * (6 + r) + 3 + c] = 0.5f * dR[3 * r + c] * dt2;
                }
            for (int r = 0; r < 3; ++r) A[9 * (6 + r) + 3 + r] = dt;
            // position / velocity (old dR)
            for (int r = 0; r < 3; ++r) {
                const float dV = S[O_DV + r];
                S[O_DP + r] = S[O_DP + r] + dV * dt + 0.5f * Ra[r] * dt2;
                S[O_DV + r] = dV + Ra[r] * dt;
            }
            // bias Jacobians (old values throughout)
            float JRg[9], JVg[9], JVa[9], JPg[9], JPa[9], RWaJ[9], dRiT[9],
                RiJ[9];
            for (int k = 0; k < 9; ++k) {
                JRg[k] = S[O_JRG + k]; JVg[k] = S[O_JVG + k];
                JVa[k] = S[O_JVA + k]; JPg[k] = S[O_JPG + k];
                JPa[k] = S[O_JPA + k];
            }
            mm3(RWa, JRg, RWaJ);
            for (int r = 0; r < 3; ++r)
                for (int c = 0; c < 3; ++c) dRiT[3 * r + c] = dRi[3 * c + r];
            mm3(dRiT, JRg, RiJ);
            for (int k = 0; k < 9; ++k) {
                S[O_JPA + k] = JPa[k] + JVa[k] * dt - 0.5f * dR[k] * dt2;
                S[O_JPG + k] = JPg[k] + JVg[k] * dt - 0.5f * RWaJ[k] * dt2;
                S[O_JVA + k] = JVa[k] - dR[k] * dt;
                S[O_JVG + k] = JVg[k] - RWaJ[k] * dt;
                S[O_JRG + k] = RiJ[k] - Jr[k] * dt;
            }
            float dRn[9];
            mm3(dR, dRi, dRn);
            normalize_rotation(dRn);
            for (int k = 0; k < 9; ++k) S[O_DR + k] = dRn[k];
            S[O_DT] = S[O_DT] + dt;
            for (int q = 0; q < 3; ++q) {
                S[O_AVGA + q] = S[O_AVGA + q] + acc[3 * i + q];
                S[O_AVGW + q] = S[O_AVGW + q] + gyro[3 * i + q];
            }
            n_s = n_s + 1.0f;
        }
        __syncthreads();
        if (tid < 81) {           // T = A C[:9, :9]
            const int r = tid / 9, c = tid % 9;
            float s = 0.0f;
            for (int k = 0; k < 9; ++k) s += A[9 * r + k] * S[O_C + 15 * k + c];
            T[tid] = s;
        }
        __syncthreads();
        if (tid < 81) {           // C[:9, :9] = T A^T + (B N) B^T
            const int r = tid / 9, c = tid % 9;
            float s = 0.0f;
            for (int k = 0; k < 9; ++k) s += T[9 * r + k] * A[9 * c + k];
            float u = 0.0f;
            for (int k = 0; k < 6; ++k)
                u += (B[6 * r + k] * cov[k]) * B[6 * c + k];
            S[O_C + 15 * r + c] = s + u;
        } else if (tid < 87) {    // random-walk block
            const int q = tid - 81;
            S[O_C + 15 * (9 + q) + 9 + q] += cov_walk[q] * dt;
        }
        __syncthreads();
    }
    const float n = fmaxf(n_s, 1.0f);
    for (int k = tid; k < PACK; k += THREADS) {
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
    preintegrate_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)acc, (const float*)gyro, (const float*)dts,
        (const uint8_t*)mask, (const float*)bias, (const float*)cov,
        (const float*)cov_walk, (const float*)init, N, (float*)out);
    return (int)cudaGetLastError();
}
