// The raw (distorted) projection of cameras.py:project_distorted on the
// device: Kannala-Brandt-8 (kind 1) and the radial-tangential pinhole
// (kind 0), params as cameras.Camera lays them out. Every product and sum
// is written in the order of cameras.py (_kb8_project; distort for the
// pinhole); a source that includes this header and wants the plain
// version's rounding compiles with -fmad=false (ops/cuda_build.py), so no
// product is fused into an FMA.
#pragma once
#include <cuda_runtime.h>

__device__ __forceinline__ void project_raw(int kind, const float* p, float x,
                                            float y, float z, float* u,
                                            float* v) {
    if (kind == 1) {
        const float r = sqrtf(x * x + y * y);
        const float theta = atan2f(r, z);
        const float t2 = theta * theta;
        const float theta_d =
            theta * (1.0f + t2 * (p[4] + t2 * (p[5] + t2 * (p[6] + t2 * p[7]))));
        const float scale = r < 1e-9f ? 0.0f : theta_d / r;
        *u = p[0] * scale * x + p[2];
        *v = p[1] * scale * y + p[3];
        return;
    }
    const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;
    const float xn = x / zs, yn = y / zs;
    const float r2 = xn * xn + yn * yn;
    const float radial = 1.0f + r2 * (p[4] + r2 * (p[5] + r2 * p[8]));
    const float xd = xn * radial + 2.0f * p[6] * xn * yn +
                     p[7] * (r2 + 2.0f * xn * xn);
    const float yd = yn * radial + p[6] * (r2 + 2.0f * yn * yn) +
                     2.0f * p[7] * xn * yn;
    *u = p[0] * xd + p[2];
    *v = p[1] * yd + p[3];
}
