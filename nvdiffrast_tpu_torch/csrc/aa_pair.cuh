// Antialias pair math shared by the kernels: the triangle choice of a
// pixel pair and its edge crossing analysis (forward: shade_fwd.cu,
// aa_fwd.cu), one axis of the colour backward and the pair's position
// gradient (backward: pipeline_bwd.cu, aa_bwd.cu, grad_scatter.cu). The
// device forms of ops/antialias.py pair_ids, pair_alpha and
// pair_pos_grad (nvdiffrast_tpu/ops/antialias.py:92-298) and of one axis
// of antialias_pallas.aa_backward_fused_cols. Built with -fmad=false;
// each expression keeps the reference's operation order.
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


// One axis of the antialias backward at pixel p, whose pair partner is q
// (borders folded onto p): subtracts the pixel's own pair blend
// al * pdy from the colour gradient gc[C], and returns the pair's table
// row (its triangle's b*T + t, or b*T where the pair has none) and its
// colour-dot weight, kept where the pair's triangle is real, dd != 0
// and |alpha| < 0.5, else 0 (antialias_pallas.py:391-404).
template <int C>
__device__ __forceinline__ void bwd_axis(int q, int N, int T, int ro, float id0, float al,
                                         float ax, const float* __restrict__ idf,
                                         const float* __restrict__ ct,
                                         const float* __restrict__ dy, const float* dy0,
                                         const float* c0p, float* gc, int& rid, float& kept) {
    const bool apos = al > 0.0f;
    float pdy[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        pdy[c] = apos ? dy0[c] : dy[static_cast<size_t>(c) * N + q];
        gc[c] = gc[c] - al * pdy[c];
    }
    const bool is_t1 = ax >= 3.5f;
    const bool active = al != 0.0f;
    const float idfs = is_t1 ? idf[q] : id0;
    const int tsel = static_cast<int>(idfs) - 1;
    const bool ok = active && tsel >= 0 && tsel < T;
    rid = (ok ? tsel : 0) + ro;
    float dd = 0.0f;
    if (active) {
#pragma unroll
        for (int c = 0; c < C; ++c) dd = dd + pdy[c] * (ct[static_cast<size_t>(c) * N + q] - c0p[c]);
    }
    kept = (ok && dd != 0.0f && fabsf(al) < 0.5f) ? dd : 0.0f;
}

__device__ __forceinline__ float vert(const float* t9, int idx, int comp) {
    return idx == 2 ? t9[6 + comp] : (idx == 1 ? t9[3 + comp] : t9[comp]);
}

// Analytic d(alpha)/d(p1, p2) of one pair, routed into 9 columns
// (antialias.pair_pos_grad). D = 0 horizontal pair, 1 vertical.
template <int D>
__device__ __forceinline__ void pair_pos_grad(const float* t9, float dd, float aux, float fx,
                                              float fy, float pxh, float pyh, float* out) {
    const bool is_t1 = aux >= 3.5f;
    const int di = static_cast<int>(aux - 4.0f * (is_t1 ? 1.0f : 0.0f));
    const int i1 = di < 2 ? di + 1 : 0;
    const int i2 = i1 < 2 ? i1 + 1 : 0;
    float p1x = vert(t9, i1, 0), p1y = vert(t9, i1, 1);
    const float p1w = vert(t9, i1, 2);
    float p2x = vert(t9, i2, 0), p2y = vert(t9, i2, 1);
    const float p2w = vert(t9, i2, 2);
    const float shift = is_t1 ? 1.0f : 0.0f;
    float fxs = fx + shift * static_cast<float>(1 - D);
    float fys = fy + shift * static_cast<float>(D);
    if (D == 1) {
        float q;
        q = p1x; p1x = p1y; p1y = q;
        q = p2x; p2x = p2y; p2y = q;
        q = pxh; pxh = pyh; pyh = q;
        q = fxs; fxs = fys; fys = q;
    }
    const float w1 = 1.0f / p1w;
    const float w2 = 1.0f / p2w;
    const float x1 = p1x * w1 * pxh - fxs;
    const float y1 = p1y * w1 * pyh - fys;
    const float x2 = p2x * w2 * pxh - fxs;
    const float y2 = p2y * w2 * pyh - fys;
    const float dxe = x2 - x1;
    const float dye = y2 - y1;
    const float db = x1 * dye - y1 * dxe;
    const float ep = dye >= 0.0f ? 1e-3f : -1e-3f;  // copysign(1e-3, dy)
    const float iy = 1.0f / (dye + ep);
    const float dby = db * iy;
    const float iw1 = -w1 * iy * dd;
    const float iw2 = w2 * iy * dd;
    float gp1x = iw1 * pxh * y2;
    float gp2x = iw2 * pxh * y1;
    float gp1y = iw1 * pyh * (dby - x2);
    float gp2y = iw2 * pyh * (dby - x1);
    const float gp1w = -(p1x * gp1x + p1y * gp1y) * w1;
    const float gp2w = -(p2x * gp2x + p2y * gp2y) * w2;
    if (D == 1) {
        float q;
        q = gp1x; gp1x = gp1y; gp1y = q;
        q = gp2x; gp2x = gp2y; gp2y = q;
    }
    const float g1[3] = {gp1x, gp1y, gp1w};
    const float g2[3] = {gp2x, gp2y, gp2w};
#pragma unroll
    for (int vtx = 0; vtx < 3; ++vtx) {
#pragma unroll
        for (int comp = 0; comp < 3; ++comp) {
            const float val = (i1 == vtx ? g1[comp] : 0.0f) + (i2 == vtx ? g2[comp] : 0.0f);
            out[3 * vtx + comp] = isfinite(val) ? val : 0.0f;
        }
    }
}

}  // namespace nvdr_aa
