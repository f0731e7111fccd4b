// The cube-map lookup's per-pixel setup: face selection, the face
// coordinates (s, t) with their clip and validity, the footprint
// Jacobian d(s, t)/d(X, Y) and the mip level, one pass over the pixels.
//
// Replaces: no Pallas kernel. The JAX package computes these in XLA
// (nvdiffrast_tpu/ops/texture.py, _cube_faceid, _cube_project and
// _cube_st_da_cols, then _mip_level_from_footprint_cols and the clip),
// where XLA fuses the elementwise chain. As PyTorch glue in texture()
// (ops/texture_cube.py cube_faceid, cube_project, cube_st_da, then
// texture.mip_level) it was ~120 launches over full [N] columns, each
// writing a float or bool column, reading the strided views of uv and
// uv_da again, and selecting the face twice.
//
//   in   uv [N, 3] directions and uv_da [N, 6] their screen derivatives
//        (dx/dX, dx/dY, dy/dX, dy/dY, dz/dX, dz/dY), each through its
//        element and component strides; bias [N]
//   out  s, t, flevel [3, N] float32; finite, face, tz [3, N] int32 (what
//        the cube sampler and its tiles pass read); da [4, N] (ds/dX,
//        ds/dY, dt/dX, dt/dY), only where the caller keeps it for the
//        level's vjp
//
// The level is computed here from the Jacobian in registers, through
// mip_level.cuh's footprint, so it has the bits nvdr_mip_level would give
// for the same da. Without uv_da and bias the level is 0 (no mip filter).
//
// Bound on the H100: device-memory traffic, 36 bytes a pixel read
// (direction and derivatives; 4 more with a bias) and 24 written (16
// more with da). One thread a pixel in a grid-stride loop; no shared
// memory. The strided [N, 3] and [N, 6] rows of a warp span 384 and 768
// contiguous bytes, which its loads share through L1.
//
// Rounding: bit for bit what the plain twin (ops/texture_cube_cuda.py
// cube_setup_plain: cube_faceid, cube_project, cube_st_da, then
// mip_level_plain) gives on CUDA tensors, where each PyTorch op is its
// own kernel and rounds on its own. Built with -fmad=false, the same
// operation order, IEEE division for dc / c_safe; `0.5 / |c_safe|` is a
// reciprocal, then a multiply (Tensor.__rtruediv__), so a subnormal c
// gives inf as the twin does; max / min propagate NaN as torch.maximum /
// torch.minimum do, so a NaN component never selects z or y. Nothing
// flushes subnormals to zero.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "mip_level.cuh"

namespace {

using namespace nvdr_mip;

constexpr int BLOCK = 256;
constexpr int MAX_BLOCKS = 132 * 16;

// cube_faceid and _face_terms: the major axis (ties go to z only when
// |z| is strictly the largest, then to y when |y| > |x|), the face
// (0 +x, 1 -x, 2 +y, 3 -y, 4 +z, 5 -z), the components on the s and t
// axes, |c| > 0, c with 1 where it is 0, and the signed scales.
struct Face {
    bool x_major, y_major, z_major, ok;
    int face;
    float u_in, v_in, c_safe, m0, m1;
};

__device__ __forceinline__ Face face_terms(float x, float y, float z) {
    Face f;
    const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
    f.z_major = az > nan_max(ax, ay);
    f.y_major = !f.z_major && (ay > ax);
    f.x_major = !(f.z_major || f.y_major);
    const float c = f.z_major ? z : (f.y_major ? y : x);
    f.face = (f.z_major ? 4 : (f.y_major ? 2 : 0)) + (c < 0.0f ? 1 : 0);
    f.u_in = f.x_major ? z : x;
    f.v_in = f.y_major ? z : y;
    f.ok = fabsf(c) > 0.0f;
    f.c_safe = f.ok ? c : 1.0f;
    const float m = (1.0f / fabsf(f.c_safe)) * 0.5f;
    f.m0 = (f.face == 0 || f.face == 5) ? -m : m;
    f.m1 = f.face == 2 ? m : -m;
    return f;
}

// The face coordinate clipped to [0, 1], 0 where the lookup is invalid.
__device__ __forceinline__ float clip01(float v, bool finite) {
    return nan_min(nan_max(finite ? v : 0.0f, 0.0f), 1.0f);
}

template <bool DA>
__global__ void __launch_bounds__(BLOCK)
cube_setup_kernel(const float* __restrict__ uv, int64_t ues, int64_t ucs,
                  const float* __restrict__ uvd, int64_t des, int64_t dcs,
                  const float* __restrict__ bias, float* __restrict__ fout,
                  int* __restrict__ iout, float* __restrict__ da_out, int N, int hw, float tw,
                  float top) {
    const int64_t n = N;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x; i < n;
         i += static_cast<int64_t>(gridDim.x) * BLOCK) {
        const float* p = uv + i * ues;
        const float x = p[0], y = p[ucs], z = p[2 * ucs];
        const Face f = face_terms(x, y, z);
        const float s = f.u_in * f.m0 + 0.5f;
        const float t = f.v_in * f.m1 + 0.5f;
        const bool finite = f.ok && isfinite(s) && isfinite(t);
        float fl = 0.0f;
        if (DA) {
            // _st_da_terms: per screen axis k (X, Y), e = dc / c,
            // ds = m0 (du - u_in e), dt = m1 (dv - v_in e).
            const float* q = uvd + i * des;
            float col[4];
            for (int k = 0; k < 2; ++k) {
                const float dx = q[k * dcs], dy = q[(2 + k) * dcs], dz = q[(4 + k) * dcs];
                const float du = f.x_major ? dz : dx;
                const float dv = f.y_major ? dz : dy;
                const float dc = f.z_major ? dz : (f.y_major ? dy : dx);
                const float e = dc / f.c_safe;
                col[k] = f.m0 * (du - f.u_in * e);
                col[2 + k] = f.m1 * (dv - f.v_in * e);
            }
            const bool keep = f.ok && isfinite(col[0]) && isfinite(col[1]) &&
                              isfinite(col[2]) && isfinite(col[3]);
            for (int k = 0; k < 4; ++k) col[k] = keep ? col[k] : 0.0f;
            if (da_out != nullptr)
                for (int k = 0; k < 4; ++k) da_out[k * n + i] = col[k];
            fl = footprint_level(footprint(col[0], col[1], col[2], col[3], tw, tw));
        }
        if (bias != nullptr) fl = fl + bias[i];
        fout[i] = clip01(s, finite);
        fout[n + i] = clip01(t, finite);
        fout[2 * n + i] = clamp(fl, 0.0f, top);
        iout[i] = finite ? 1 : 0;
        iout[n + i] = f.face;
        iout[2 * n + i] = hw > 0 ? static_cast<int>(i / hw) : 0;
    }
}

}  // namespace

// uv [N, 3] float32 at element stride ues and component stride ucs; uvd
// [N, 6] at des, dcs, or nullptr (no footprint); bias [N] or nullptr ->
// fout [3, N] (s, t, flevel) and iout [3, N] (finite, face, tz), and da
// [4, N] where da_out is not nullptr (needs uvd). hw: the pixels of an
// image, tz = p / hw (0: one texture, tz = 0); w: the base level's face
// width; L: the number of levels.
extern "C" int nvdr_cube_setup(const float* uv, long long ues, long long ucs, const float* uvd,
                               long long des, long long dcs, const float* bias, float* fout,
                               int* iout, float* da_out, int N, int hw, int w, int L,
                               void* stream) {
    if (N <= 0) return static_cast<int>(cudaGetLastError());
    if (L < 1 || w < 1 || hw < 0 || (da_out != nullptr && uvd == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const float tw = static_cast<float>(w);
    const float top = static_cast<float>(L - 1);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int grid = std::min(N / BLOCK + 1, MAX_BLOCKS);
    if (uvd != nullptr)
        cube_setup_kernel<true><<<grid, BLOCK, 0, s>>>(uv, ues, ucs, uvd, des, dcs, bias, fout,
                                                       iout, da_out, N, hw, tw, top);
    else
        cube_setup_kernel<false><<<grid, BLOCK, 0, s>>>(uv, ues, ucs, uvd, des, dcs, bias, fout,
                                                        iout, da_out, N, hw, tw, top);
    return static_cast<int>(cudaGetLastError());
}
