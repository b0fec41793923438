// Forward-mode dual numbers (value, one tangent) and the port's lie.py
// maps on them: so3_exp, so3_log with its small-angle and near-pi branches,
// 3x3 products. The kernels that need a Jacobian at zero tangent (K12
// pose_inertial.cu, K13 vi_edges.cu, K15 pose_graph.cu) seed lane d with
// the unit tangent e_d and read column d of the Jacobian off the
// derivative parts, as torch.func.jacfwd does. Branches follow lie.py: a
// clamp passes no derivative outside its range, as torch's clamp.
#pragma once
#include <cuda_runtime.h>

#define PI_F 3.14159265358979f

struct Dl {
    float v, d;
};
__device__ __forceinline__ Dl dl(float v) { return Dl{v, 0.0f}; }
__device__ __forceinline__ Dl operator+(Dl a, Dl b) {
    return Dl{a.v + b.v, a.d + b.d};
}
__device__ __forceinline__ Dl operator-(Dl a, Dl b) {
    return Dl{a.v - b.v, a.d - b.d};
}
__device__ __forceinline__ Dl operator-(Dl a) { return Dl{-a.v, -a.d}; }
__device__ __forceinline__ Dl operator*(Dl a, Dl b) {
    return Dl{a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ __forceinline__ Dl operator*(float s, Dl a) {
    return Dl{s * a.v, s * a.d};
}
__device__ __forceinline__ Dl operator/(Dl a, Dl b) {
    return Dl{a.v / b.v, (a.d * b.v - a.v * b.d) / (b.v * b.v)};
}
__device__ __forceinline__ Dl dsqrt(Dl a) {
    const float s = sqrtf(a.v);
    return Dl{s, a.d / (2.0f * s)};
}
__device__ __forceinline__ Dl dsin(Dl a) {
    return Dl{sinf(a.v), cosf(a.v) * a.d};
}
__device__ __forceinline__ Dl dcos(Dl a) {
    return Dl{cosf(a.v), -sinf(a.v) * a.d};
}
// clamp: the derivative passes only inside [lo, hi]
__device__ __forceinline__ Dl dclamp(Dl a, float lo, float hi) {
    if (a.v < lo) return Dl{lo, 0.0f};
    if (a.v > hi) return Dl{hi, 0.0f};
    return a;
}
__device__ __forceinline__ Dl dclamp_min(Dl a, float lo) {
    if (a.v < lo) return Dl{lo, 0.0f};
    return a;
}
__device__ __forceinline__ Dl dacos(Dl a) {
    return Dl{acosf(a.v), -a.d / sqrtf(1.0f - a.v * a.v)};
}

// lie.py _sinc / _cosc with their |x| < 1e-4 series branches
__device__ Dl dsinc(Dl x) {
    if (fabsf(x.v) < 1e-4f) return dl(1.0f) - (1.0f / 6.0f) * (x * x);
    return dsin(x) / x;
}
__device__ Dl dcosc(Dl x) {
    if (fabsf(x.v) < 1e-4f) return dl(0.5f) - (1.0f / 24.0f) * (x * x);
    return (dl(1.0f) - dcos(x)) / (x * x);
}

__device__ void dhat(const Dl* w, Dl* W) {
    W[0] = dl(0.0f); W[1] = -w[2];    W[2] = w[1];
    W[3] = w[2];     W[4] = dl(0.0f); W[5] = -w[0];
    W[6] = -w[1];    W[7] = w[0];     W[8] = dl(0.0f);
}

__device__ void dexp(const Dl* w, Dl* R) {
    const Dl n2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
    const Dl theta = dsqrt(n2 + dl(1e-24f));
    Dl W[9];
    dhat(w, W);
    const Dl a = dsinc(theta), b = dcosc(theta);
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            const Dl W2 = w[i] * w[j] - (i == j ? n2 : dl(0.0f));
            R[3 * i + j] = dl(i == j ? 1.0f : 0.0f) + a * W[3 * i + j] +
                           b * W2;
        }
}

__device__ void dmm(const Dl* A, const Dl* B, Dl* C) {
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] +
                           A[3 * i + 2] * B[6 + j];
}
__device__ void dmv(const Dl* A, const Dl* x, Dl* y) {
    for (int i = 0; i < 3; ++i)
        y[i] = A[3 * i] * x[0] + A[3 * i + 1] * x[1] + A[3 * i + 2] * x[2];
}
__device__ void dT(const Dl* A, Dl* B) {
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) B[3 * i + j] = A[3 * j + i];
}

// lie.so3_log, robust near 0 and pi
__device__ void dlog(const Dl* R, Dl* out) {
    const Dl tr = R[0] + R[4] + R[8];
    const Dl c = dclamp((tr - dl(1.0f)) * dl(0.5f), -1.0f + 1e-7f,
                        1.0f - 1e-7f);
    const Dl theta = dacos(c);
    Dl wg[3] = {0.5f * (R[7] - R[5]), 0.5f * (R[2] - R[6]),
                0.5f * (R[3] - R[1])};
    if (PI_F - theta.v >= 1e-3f) {
        const Dl scale = theta.v < 1e-4f
            ? dl(1.0f) + (1.0f / 6.0f) * (theta * theta)
            : theta / dsin(theta);
        for (int q = 0; q < 3; ++q) out[q] = wg[q] * scale;
        return;
    }
    Dl Bm[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
            Bm[3 * i + j] = 0.5f * (R[3 * i + j] + R[3 * j + i]);
    const Dl om = dclamp_min(dl(1.0f) - c, 1e-8f);
    Dl a2[3], a[3];
    for (int q = 0; q < 3; ++q) {
        a2[q] = dclamp_min((Bm[4 * q] - c) / om, 1e-12f);
        a[q] = dsqrt(a2[q]);
    }
    int idx = 0;
    for (int q = 1; q < 3; ++q)
        if (a2[q].v > a2[idx].v) idx = q;
    const Dl row[3] = {idx == 0 ? Bm[0] : Bm[3 * idx], Bm[3 * idx + 1],
                       Bm[3 * idx + 2]};
    Dl as[3];
    float dot = 0.0f;
    for (int q = 0; q < 3; ++q) {
        const float sg = (q == idx) ? 1.0f : (row[q].v < 0.0f ? -1.0f : 1.0f);
        as[q] = sg * a[q];
    }
    Dl dotd = as[0] * wg[0] + as[1] * wg[1] + as[2] * wg[2];
    dot = dotd.v;
    for (int q = 0; q < 3; ++q) out[q] = (dot < 0.0f ? -1.0f : 1.0f) *
                                         (as[q] * theta);
}
