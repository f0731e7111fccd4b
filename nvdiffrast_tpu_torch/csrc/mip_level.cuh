// The mip level's arithmetic, shared by the level kernels (mip_level.cu)
// and the cube-map setup kernel (texture_cube_setup.cu), which computes
// the level from the footprint Jacobian it holds in registers.
//
// Mirrors ops/texture.py mip_level_plain and level_vjp_plain in their
// float32 operation order; the files that include it are built with
// -fmad=false, so the level has the same bits whichever kernel computes
// it, and the plain twins on the card agree to the bit (mip_level.cu's
// header sets out the rounding rules).
#pragma once
#include <cuda_runtime.h>

namespace nvdr_mip {

// The Python scalars as PyTorch hands them to its kernels (double ->
// float).
constexpr float FLOOR = static_cast<float>(1e-38);
constexpr float L2A_MIN = static_cast<float>(1e-30);
// float32 log(2) (texture._LN2), and its reciprocal as div_true_kernel_cuda
// computes it on the host.
constexpr float LN2 = static_cast<float>(0.6931471805599453);
constexpr float INV_LN2 = 1.0f / LN2;

// torch.clamp(v, min=lo): NaN passes.
__device__ __forceinline__ float clamp_min(float v, float lo) {
    return isnan(v) ? v : fmaxf(v, lo);
}

// torch.clamp(v, lo, hi): NaN passes.
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
    return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.maximum / torch.minimum: a NaN operand is the result.
__device__ __forceinline__ float nan_max(float a, float b) {
    return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
    return isnan(a) ? a : isnan(b) ? b : fminf(a, b);
}

// JAX's derivative of max/min(x, other) = out with respect to x
// (texture._tie): 1 where x is the result, half of it on a tie.
__device__ __forceinline__ float tie(float x, float out, float other) {
    return (x == out ? 1.0f : 0.0f) / (other == out ? 2.0f : 1.0f);
}

// The footprint's terms, in the twins' order.
struct Footprint {
    float dsdx, dsdy, dtdx, dtdy, A, B, C, t7, l2n, l2a, s, lms, fl0;
};

// From the four derivatives (du/dX, du/dY, dv/dX, dv/dY) and the base
// level's size.
__device__ __forceinline__ Footprint footprint(float da0, float da1, float da2, float da3,
                                               float tw, float th) {
    Footprint f;
    f.dsdx = da0 * tw;
    f.dsdy = da1 * tw;
    f.dtdx = da2 * th;
    f.dtdy = da3 * th;
    f.A = f.dsdx * f.dsdx + f.dtdx * f.dtdx;
    f.B = f.dsdy * f.dsdy + f.dtdy * f.dtdy;
    f.C = f.dsdx * f.dsdy + f.dtdx * f.dtdy;
    const float l2b = 0.5f * (f.A + f.B);
    f.t7 = 0.25f * (f.A - f.B);
    f.l2n = f.t7 * (f.A - f.B) + f.C * f.C;
    f.l2a = sqrtf(f.l2n);
    f.s = l2b + f.l2a;
    f.lms = clamp_min(f.s, FLOOR);
    f.fl0 = 0.5f * log2f(f.lms);
    return f;
}

// The footprint's level with NaN -> 0 (_mip_level_from_footprint_cols).
__device__ __forceinline__ float footprint_level(const Footprint& f) {
    return isnan(f.fl0) ? 0.0f : f.fl0;
}

}  // namespace nvdr_mip
