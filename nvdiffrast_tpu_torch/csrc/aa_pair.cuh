// Antialias pair math shared by the forward kernels (shade_fwd.cu,
// aa_fwd.cu): the triangle choice of a pixel pair and its edge crossing
// analysis, the device forms of ops/antialias.py pair_ids and pair_alpha
// (nvdiffrast_tpu/ops/antialias.py:92-215). Built with -fmad=false; each
// expression keeps the reference's operation order.
#pragma once

#include <cuda_runtime.h>
#include <cfloat>

namespace nvdr_aa {

// Sign-bit comparison on the int32 bitcast: +-0.0 differ.
__device__ __forceinline__ bool same_sign(float a, float b) {
    return (__float_as_int(a) ^ __float_as_int(b)) >= 0;
}

__device__ __forceinline__ bool rational_gt(float n0, float n1, float d0, float d1) {
    return (n0 * d1 > n1 * d0) == same_sign(d0, d1);
}

__device__ __forceinline__ int max_idx3(float n0, float n1, float n2, float d0, float d1,
                                        float d2) {
    const bool g10 = rational_gt(n1, n0, d1, d0);
    const bool g20 = rational_gt(n2, n0, d2, d0);
    const bool g21 = rational_gt(n2, n1, d2, d1);
    return (g20 && g21) ? 2 : (g10 ? 1 : 0);
}

__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
    return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// Triangle choice for a pixel pair (antialias.pair_ids): the pixel's
// (id0, z0) and its neighbour's (id1, z1), borders already folded.
__device__ __forceinline__ void pair_ids(float id0, float id1, float z0, float z1, int T,
                                         int& tsel, bool& is_t1, bool& active) {
    const int tri0 = static_cast<int>(id0) - 1;
    const int tri1 = static_cast<int>(id1) - 1;
    const bool work = id1 != id0;
    tsel = tri0 >= 0 ? tri0 : tri1;
    if (tri0 >= 0 && tri1 >= 0) tsel = (z0 < z1) ? tri0 : tri1;
    is_t1 = tsel == tri1;
    const bool tri_ok = (tsel >= 0) && (tsel < T);
    active = work && tri_ok;
    if (!tri_ok) tsel = 0;
}

// Edge crossing analysis of one pixel pair (antialias.pair_alpha).
// t: gathered (sx0, sx1, sx2, sy0, sy1, sy2, sign bits) of the chosen
// triangle; D = 0 right neighbour, 1 down neighbour.
template <int D>
__device__ __forceinline__ void pair_alpha(const float* t, float fx, float fy, bool is_t1,
                                           bool active, float& alpha, int& di) {
    const float shift = is_t1 ? 1.0f : 0.0f;
    const float fxs = fx + shift * static_cast<float>(1 - D);
    const float fys = fy + shift * static_cast<float>(D);
    float x0 = t[0] - fxs, x1 = t[1] - fxs, x2 = t[2] - fxs;
    float y0 = t[3] - fys, y1 = t[4] - fys, y2 = t[5] - fys;
    const int sb = static_cast<int>(t[6]);
    const bool s0 = (sb & 1) != 0, s1 = (sb & 2) != 0, s2 = (sb & 4) != 0;
    const bool any_sil = s0 || s1 || s2;
    if (D == 1) {  // XY flip for horizontal edges
        float q;
        q = x0; x0 = y0; y0 = q;
        q = x1; x1 = y1; y1 = q;
        q = x2; x2 = y2; y2 = q;
    }
    const float dx0 = x2 - x1, dx1 = x0 - x2, dx2 = x1 - x0;
    float dy0 = y2 - y1, dy1 = y0 - y2, dy2 = y1 - y0;
    const float ds = is_t1 ? -1.0f : 1.0f;
    float d0 = ds * (x1 * dy0 - y1 * dx0);
    float d1 = ds * (x2 * dy1 - y2 * dx1);
    float d2 = ds * (x0 * dy2 - y0 * dx2);
    if (same_sign(y1, y2)) { d0 = -FLT_MAX; dy0 = 1.0f; }
    if (same_sign(y2, y0)) { d1 = -FLT_MAX; dy1 = 1.0f; }
    if (same_sign(y0, y1)) { d2 = -FLT_MAX; dy2 = 1.0f; }
    di = max_idx3(d0, d1, d2, dy0, dy1, dy2);
    float dc = -FLT_MAX;
    if (di == 0 && s0 && fabsf(dy0) >= fabsf(dx0)) dc = d0 / dy0;
    if (di == 1 && s1 && fabsf(dy1) >= fabsf(dx1)) dc = d1 / dy1;
    if (di == 2 && s2 && fabsf(dy2) >= fabsf(dx2)) dc = d2 / dy2;
    const bool found = (dc > -0.0625f) && (dc < 1.0625f);
    const float a = (active && any_sil && found) ? ds * (0.5f - clip_nan(dc, 0.0f, 1.0f)) : 0.0f;
    alpha = isfinite(a) ? a : 0.0f;
}

}  // namespace nvdr_aa
