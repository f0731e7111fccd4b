// Bilinear corner setup of the 2-D texture sampler, shared by the forward
// (texture_fwd.cu) and the uv / level backward (texture_bwd.cu).
//
// Mirrors nvdiffrast_tpu/ops/texture_pallas.py corner_setup and
// level_weights in the reference's float32 operation order; the files
// that include it are built with -fmad=false, so the plain twins
// (ops/texture_cuda.py level_corners, level_weights) agree to the bit.
#pragma once
#include <cuda_runtime.h>

namespace nvdr_tex {

constexpr int MAX_LEVELS = 17;  // texture.MAX_MIP_LEVEL + the base level

enum Boundary { WRAP = 0, CLAMP = 1, ZERO = 2 };
enum Filter { LINEAR = 0, MIP_NEAREST = 1, MIP_LINEAR = 2 };

struct Levels {
    int off[MAX_LEVELS];
    int h[MAX_LEVELS];
    int w[MAX_LEVELS];
};

// meta: L triples (off, h, w) in host memory.
inline Levels levels_from_meta(const int* meta, int L) {
    Levels lv = {};
    for (int l = 0; l < L; ++l) {
        lv.off[l] = meta[3 * l];
        lv.h[l] = meta[3 * l + 1];
        lv.w[l] = meta[3 * l + 2];
    }
    return lv;
}

__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
    return x != x ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// The level pair (l0, l1) and blend weight frac of a pixel.
__device__ __forceinline__ void level_weights(float fl, int L, int filter, int& l0, int& l1,
                                              float& frac) {
    l0 = 0;
    l1 = 0;
    frac = 0.0f;
    if (filter != LINEAR) {
        l0 = clampi(static_cast<int>(floorf(fl)), 0, L - 1);
        l1 = l0;
        if (filter == MIP_LINEAR) {
            l1 = min(l0 + 1, L - 1);
            frac = fl - static_cast<float>(l0);
        }
    }
}

// Corners of one level: texel offsets (relative to the level's texture
// base) in (00, 10, 01, 11) order, the fractions, the weights with the
// zero boundary's validity folded in, and that validity.
struct Corners {
    int idx[4];
    float fu, fv;
    float w[4];
    float ok[4];
};

__device__ __forceinline__ Corners corner_setup(int hl, int wl, float u, float v, int boundary) {
    const float w = static_cast<float>(wl);
    const float h = static_cast<float>(hl);
    if (boundary == WRAP) {
        u = u - floorf(u);
        v = v - floorf(v);
    }
    u = u * w - 0.5f;
    v = v * h - 0.5f;
    bool clamp_u = false, clamp_v = false;
    if (boundary == CLAMP) {
        u = clip_nan(u, 0.0f, w - 1.0f);
        v = clip_nan(v, 0.0f, h - 1.0f);
        clamp_u = (u == 0.0f) || (u == w - 1.0f);
        clamp_v = (v == 0.0f) || (v == h - 1.0f);
    }
    int iu0 = static_cast<int>(floorf(u));
    int iv0 = static_cast<int>(floorf(v));
    int iu1 = iu0 + (clamp_u ? 0 : 1);
    int iv1 = iv0 + (clamp_v ? 0 : 1);
    Corners k;
    k.fu = u - static_cast<float>(iu0);
    k.fv = v - static_cast<float>(iv0);
    if (boundary == WRAP) {
        iu0 = iu0 < 0 ? iu0 + wl : iu0;
        iv0 = iv0 < 0 ? iv0 + hl : iv0;
        iu1 = iu1 >= wl ? iu1 - wl : iu1;
        iv1 = iv1 >= hl ? iv1 - hl : iv1;
    }
    k.ok[0] = k.ok[1] = k.ok[2] = k.ok[3] = 1.0f;
    if (boundary == ZERO) {
        // Validity rides in the weights; the indices are clamped below.
        const float u0 = (iu0 >= 0 && iu0 < wl) ? 1.0f : 0.0f;
        const float u1 = (iu1 >= 0 && iu1 < wl) ? 1.0f : 0.0f;
        const float v0 = (iv0 >= 0 && iv0 < hl) ? 1.0f : 0.0f;
        const float v1 = (iv1 >= 0 && iv1 < hl) ? 1.0f : 0.0f;
        k.ok[0] = u0 * v0;
        k.ok[1] = u1 * v0;
        k.ok[2] = u0 * v1;
        k.ok[3] = u1 * v1;
    }
    const float gu = 1.0f - k.fu;
    const float gv = 1.0f - k.fv;
    k.w[0] = gu * gv * k.ok[0];
    k.w[1] = k.fu * gv * k.ok[1];
    k.w[2] = gu * k.fv * k.ok[2];
    k.w[3] = k.fu * k.fv * k.ok[3];
    // Wrapped indices lie in the level already (u - floor(u) is in [0, 1]
    // or NaN, which converts to 0), and so do clamped ones but for the
    // second corner of a NaN (index 1) on a level one texel wide. The zero
    // boundary's outside corners are clamped into the level.
    if (boundary == CLAMP) {
        iu1 = min(iu1, wl - 1);
        iv1 = min(iv1, hl - 1);
    } else if (boundary == ZERO) {
        iu0 = clampi(iu0, 0, wl - 1);
        iu1 = clampi(iu1, 0, wl - 1);
        iv0 = clampi(iv0, 0, hl - 1);
        iv1 = clampi(iv1, 0, hl - 1);
    }
    k.idx[0] = iv0 * wl + iu0;
    k.idx[1] = iv0 * wl + iu1;
    k.idx[2] = iv1 * wl + iu0;
    k.idx[3] = iv1 * wl + iu1;
    return k;
}

}  // namespace nvdr_tex
