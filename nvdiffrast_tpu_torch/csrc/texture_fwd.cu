// Texture sampler forward: bilinear and trilinear sampling of 2-D textures
// from a flat-packed mip pyramid.
//
// Replaces: nvdiffrast_tpu/ops/texture_pallas.py, _call_sampler in mode
// "fwd" (kernel body _build_kernel, corner_setup, level_weights), for
// filter modes linear, linear-mipmap-nearest and linear-mipmap-linear and
// boundary modes wrap, clamp and zero.
//
// The pyramid is one texel-major buffer [n_texels, C] (ops/texture.py
// _pack_pyramid): level l's [D, h, w] block starts at texel off[l], and
// texture tz of a level is its tz-th [h, w] slab. The whole pyramid stays
// in device memory (4.2 MB for a 512x512x3 texture, resident in L2); the
// TPU's VMEM/HBM level split, lane-gather sweeps (_gather_rc) and
// windowed DMA (_gather_big) were workarounds for VMEM and have no
// counterpart here. No hardware texture filtering: the weights are the
// reference's float32 arithmetic.
//
// One thread per pixel, in 32x8 blocks of image pixels (one image per
// grid z), so a warp's uv footprint is a compact patch of the texture, as
// _tile_order gave the TPU. Per pixel: the level pair (l0, l1) and blend
// weight from flevel (level_weights); for l0 and, when it differs, l1:
// the corner setup (wrap / clamp / zero), four corner gathers of C floats
// and
//   out += wgt * (((w00*q00 + w10*q10) + w01*q01) + w11*q11),
// levels in ascending order, as the reference's level loop. Output is
// channel-major [C, N].
//
// Bound on the H100: device-memory traffic of the pixel streams (u, v,
// flevel read, C floats written: 6 words per pixel at C = 3) plus one read
// of the pyramid; the corner gathers (8 x C per pixel) hit L1/L2.
//
// Rounding: built with -fmad=false; every expression keeps the
// reference's operation order, so the plain twin (sample_plain) agrees to
// the last bit.
#include <cuda_runtime.h>

#include "texture_corner.cuh"

namespace {

using namespace nvdr_tex;

constexpr int BX = 32;
constexpr int BY = 8;

// One level's bilinear value of every channel (corner_setup + gather).
template <int C>
__device__ __forceinline__ void level_value(const float* __restrict__ tex, int base, int hl,
                                            int wl, float u, float v, int boundary,
                                            float* val) {
    const Corners k = corner_setup(hl, wl, u, v, boundary);
    const float* q00 = tex + static_cast<size_t>(base + k.idx[0]) * C;
    const float* q10 = tex + static_cast<size_t>(base + k.idx[1]) * C;
    const float* q01 = tex + static_cast<size_t>(base + k.idx[2]) * C;
    const float* q11 = tex + static_cast<size_t>(base + k.idx[3]) * C;
#pragma unroll
    for (int c = 0; c < C; ++c)
        val[c] = ((k.w[0] * __ldg(q00 + c) + k.w[1] * __ldg(q10 + c)) + k.w[2] * __ldg(q01 + c)) +
                 k.w[3] * __ldg(q11 + c);
}

template <int C>
__global__ void __launch_bounds__(BX * BY)
tex_fwd_kernel(const float* __restrict__ tex, const float* __restrict__ u,
               const float* __restrict__ v, const float* __restrict__ flevel,
               float* __restrict__ out, int H, int W, int N, int L, int per_image, int boundary,
               int filter, Levels lv) {
    const int col = blockIdx.x * BX + threadIdx.x;
    const int row = blockIdx.y * BY + threadIdx.y;
    const int b = blockIdx.z;
    if (col >= W || row >= H) return;
    const int p = (b * H + row) * W + col;
    const float up = u[p], vp = v[p];

    // Level pair and blend weight (texture_pallas.level_weights).
    int l0, l1;
    float frac;
    level_weights(filter != LINEAR ? flevel[p] : 0.0f, L, filter, l0, l1, frac);
    const int tz = per_image ? b : 0;

    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    for (int k = 0; k < 2; ++k) {
        const int lev = k == 0 ? l0 : l1;
        if (k == 1 && l1 == l0) break;
        const float wgt = ((lev == l0) ? 1.0f - frac : 0.0f) + ((lev == l1) ? frac : 0.0f);
        const int hl = lv.h[lev], wl = lv.w[lev];
        float val[C];
        level_value<C>(tex, lv.off[lev] + tz * hl * wl, hl, wl, up, vp, boundary, val);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = acc[c] + wgt * val[c];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) out[static_cast<size_t>(c) * N + p] = acc[c];
}

}  // namespace

// tex [n_texels, C] texel-major pyramid; u, v, flevel [N] with N = B*H*W
// (flevel unread for filter 0); out [C, N]. meta: L triples (off, h, w)
// in host memory. per_image: texture b for image b (else texture 0).
// boundary: 0 wrap, 1 clamp, 2 zero; filter: 0 linear, 1 linear-mipmap-
// nearest, 2 linear-mipmap-linear. 1 <= C <= 8, 1 <= L <= 17.
extern "C" int nvdr_texture_fwd(const float* tex, const float* u, const float* v,
                                const float* flevel, float* out, const int* meta, int B, int H,
                                int W, int C, int L, int per_image, int boundary, int filter,
                                void* stream) {
    if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
    if (L < 1 || L > MAX_LEVELS || boundary < 0 || boundary > 2 || filter < 0 || filter > 2)
        return static_cast<int>(cudaErrorInvalidValue);
    const Levels lv = levels_from_meta(meta, L);
    const int N = B * H * W;
    const dim3 block(BX, BY);
    const dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NVDR_TEX_CASE(n)                                                                   \
    case n:                                                                                \
        tex_fwd_kernel<n><<<grid, block, 0, s>>>(tex, u, v, flevel, out, H, W, N, L,       \
                                                 per_image, boundary, filter, lv);         \
        break;
    switch (C) {
        NVDR_TEX_CASE(1)
        NVDR_TEX_CASE(2)
        NVDR_TEX_CASE(3)
        NVDR_TEX_CASE(4)
        NVDR_TEX_CASE(5)
        NVDR_TEX_CASE(6)
        NVDR_TEX_CASE(7)
        NVDR_TEX_CASE(8)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef NVDR_TEX_CASE
    return static_cast<int>(cudaGetLastError());
}
