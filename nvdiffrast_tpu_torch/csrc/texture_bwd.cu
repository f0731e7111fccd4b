// Texture sampler backward, uv and mip level: per pixel, the gradients of
// the filtered colour to u, v and flevel.
//
// Replaces: nvdiffrast_tpu/ops/texture_pallas.py, _call_sampler in mode
// "fwd_stash" together with _sample_bwd's uv / level sums, for 2-D
// textures (filters linear, linear-mipmap-nearest, linear-mipmap-linear;
// boundaries wrap, clamp, zero).
//
// The TPU kernel writes, in the forward, each mip slot's (dqu, dqv, val)
// rows of every channel (3*C*slots floats a pixel: 302 MB at 2048^2,
// C = 3, trilinear) so that the backward is elementwise. Here the
// backward gathers the corners again instead: the forward sampler's
// corner reads are L1/L2 hits (the pyramid is 4.2 MB), so a re-gather
// costs less than writing and reading the stash, and the forward keeps
// no residual that grows with the batch.
//
// One thread per pixel, in 32x8 blocks of image pixels (one image per
// grid z), as the forward. Per slot s (slot 0 = level l0 with weight
// 1 - frac, slot 1 = level l1 with weight frac for linear-mipmap-linear;
// one slot l0 with weight 1 otherwise): the corner setup, the 4 corner
// gathers of C floats, masked by the zero boundary's validity for the
// derivatives, and
//   dqu = (1-fv)(q10-q00) + fv(q11-q01),  dqv = (1-fu)(q01-q00) + fu(q11-q10),
//   val = the slot's bilinear value,
//   gu += lw * sum_c gc_c dqu_c * w_l,  gv += lw * sum_c gc_c dqv_c * h_l,
//   gfl += sign_s * sum_c gc_c val_c   (sign -1, +1; trilinear only).
// Both slots run even where l1 == l0 (the top level): the reference adds
// slot 1 there too (gfl gets -val + val, gu the weights 1-frac and frac).
//
// Bound on the H100: device-memory traffic of the pixel streams (u, v,
// flevel and C colour cotangents read, 3 floats written: 9 words a pixel
// at C = 3); the corner gathers hit L1/L2.
//
// Rounding: built with -fmad=false in the reference's operation order;
// the plain twin (texture_bwd_plain) agrees to the last bit.
#include <cuda_runtime.h>

#include "texture_corner.cuh"

namespace {

using namespace nvdr_tex;

constexpr int BX = 32;
constexpr int BY = 8;

template <int C>
__global__ void __launch_bounds__(BX * BY)
tex_bwd_kernel(const float* __restrict__ tex, const float* __restrict__ u,
               const float* __restrict__ v, const float* __restrict__ flevel,
               const float* __restrict__ gc, float* __restrict__ out, int H, int W, int N, int L,
               int per_image, int boundary, int filter, Levels lv) {
    const int col = blockIdx.x * BX + threadIdx.x;
    const int row = blockIdx.y * BY + threadIdx.y;
    const int b = blockIdx.z;
    if (col >= W || row >= H) return;
    const int p = (b * H + row) * W + col;
    const float up = u[p], vp = v[p];
    int l0, l1;
    float frac;
    level_weights(filter != LINEAR ? flevel[p] : 0.0f, L, filter, l0, l1, frac);
    const int tz = per_image ? b : 0;
    float g[C];
#pragma unroll
    for (int c = 0; c < C; ++c) g[c] = gc[static_cast<size_t>(c) * N + p];

    const int n_slots = filter == MIP_LINEAR ? 2 : 1;
    float gu = 0.0f, gv = 0.0f, gfl = 0.0f;
    for (int s = 0; s < n_slots; ++s) {
        const int lev = s == 0 ? l0 : l1;
        const float lw = n_slots == 1 ? 1.0f : (s == 0 ? 1.0f - frac : frac);
        const int hl = lv.h[lev], wl = lv.w[lev];
        const Corners k = corner_setup(hl, wl, up, vp, boundary);
        const float* q00 = tex + static_cast<size_t>(lv.off[lev] + tz * hl * wl + k.idx[0]) * C;
        const float* q10 = tex + static_cast<size_t>(lv.off[lev] + tz * hl * wl + k.idx[1]) * C;
        const float* q01 = tex + static_cast<size_t>(lv.off[lev] + tz * hl * wl + k.idx[2]) * C;
        const float* q11 = tex + static_cast<size_t>(lv.off[lev] + tz * hl * wl + k.idx[3]) * C;
        float du = 0.0f, dv = 0.0f, dval = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            float a = __ldg(q00 + c), bq = __ldg(q10 + c), cq = __ldg(q01 + c),
                  d = __ldg(q11 + c);
            const float val = ((k.w[0] * a + k.w[1] * bq) + k.w[2] * cq) + k.w[3] * d;
            if (boundary == ZERO) {  // invalid corners: 0 in the derivatives
                a = a * k.ok[0];
                bq = bq * k.ok[1];
                cq = cq * k.ok[2];
                d = d * k.ok[3];
            }
            const float dqu = (1.0f - k.fv) * (bq - a) + k.fv * (d - cq);
            const float dqv = (1.0f - k.fu) * (cq - a) + k.fu * (d - bq);
            du = du + g[c] * dqu;
            dv = dv + g[c] * dqv;
            dval = dval + g[c] * val;
        }
        gu = gu + lw * du * static_cast<float>(wl);
        gv = gv + lw * dv * static_cast<float>(hl);
        if (n_slots == 2) gfl = gfl + (s == 0 ? -1.0f : 1.0f) * dval;
    }
    out[p] = gu;
    out[static_cast<size_t>(N) + p] = gv;
    out[2 * static_cast<size_t>(N) + p] = gfl;
}

}  // namespace

// tex [n_texels, C] texel-major pyramid; u, v, flevel [N] with N = B*H*W;
// gc [C, N] colour cotangent -> out [3, N] (gu, gv, gfl). meta, per_image,
// boundary, filter: as nvdr_texture_fwd. 1 <= C <= 8, 1 <= L <= 17.
extern "C" int nvdr_texture_bwd(const float* tex, const float* u, const float* v,
                                const float* flevel, const float* gc, float* out,
                                const int* meta, int B, int H, int W, int C, int L,
                                int per_image, int boundary, int filter, void* stream) {
    if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
    if (L < 1 || L > MAX_LEVELS || boundary < 0 || boundary > 2 || filter < 0 || filter > 2)
        return static_cast<int>(cudaErrorInvalidValue);
    const Levels lv = levels_from_meta(meta, L);
    const int N = B * H * W;
    const dim3 block(BX, BY);
    const dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NVDR_TEX_BWD_CASE(n)                                                                 \
    case n:                                                                                  \
        tex_bwd_kernel<n><<<grid, block, 0, s>>>(tex, u, v, flevel, gc, out, H, W, N, L,     \
                                                 per_image, boundary, filter, lv);           \
        break;
    switch (C) {
        NVDR_TEX_BWD_CASE(1)
        NVDR_TEX_BWD_CASE(2)
        NVDR_TEX_BWD_CASE(3)
        NVDR_TEX_BWD_CASE(4)
        NVDR_TEX_BWD_CASE(5)
        NVDR_TEX_BWD_CASE(6)
        NVDR_TEX_BWD_CASE(7)
        NVDR_TEX_BWD_CASE(8)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef NVDR_TEX_BWD_CASE
    return static_cast<int>(cudaGetLastError());
}
