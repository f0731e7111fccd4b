// Texture gradient: the colour cotangent of every pixel's bilinear taps
// summed into the packed mip pyramid, deterministic.
//
// Replaces: nvdiffrast_tpu/ops/lattice_scatter.py, _sep_kernel_call with
// its pair-list setup (lattice_scatter_grad) and the border fold
// (fold_ext_grad_sep); for per-image textures also the generic path the
// JAX package takes instead (texture_pallas.py _sample_bwd's
// generic_path through scatter.py's _scatter_pallas).
//
// The TPU kernel runs one f32 matmul per (texel tile, pixel chunk) pair
// of a separable one-hot stamp on an apron pyramid, then folds the apron
// back per boundary mode. On this card the taps are summed by texel
// instead, with no apron and no float atomics, so the gradient is the
// same on every run. The wrapper (texture_bwd_cuda.grad_entries, index
// glue) keys every tap (pixel p, mip slot s, corner dv, du) by the texel
// its corner resolves to (wrap by modulo, clamp by clamping; the zero
// boundary's outside corners and taps whose weight factors are 0 are left
// out) and stable-sorts the codes ((s*2 + dv)*2 + du)*N + p by texel;
// texel t owns codes[off[t], off[t+1]), split into pieces of PIECE taps,
// numbered first[t] .. first[t+1]-1.
//   Pass 1: one warp per piece. Its lanes walk the piece (lane l takes
//     taps l, l+32, ...), recompute each tap's weight
//     ((lw * vw_dv) * gc_c) * uw_du from u, v, flevel (level_weights and
//     lattice_setup_sep in float32, the reference's order) and sum it in
//     float64; a butterfly of shuffles adds the 32 partial sums in a
//     fixed order into partial[piece].
//   Pass 2: one warp per texel sums its pieces' partials the same way and
//     rounds to float32 once.
// The pieces keep every warp's work bounded: every background pixel
// samples uv = (0, 0) at level 0, so the four texels around it collect a
// tap from millions of pixels; one warp per texel would serialise there.
//
// Bound on the H100: device-memory traffic of the sorted codes, each
// tap's gathered pixel (u, v, flevel and C cotangents, scattered reads),
// and the [n_texels, C] output; the float64 adds are C a tap.
#include <cuda_runtime.h>

#include "texture_corner.cuh"

namespace {

using namespace nvdr_tex;

constexpr int PIECE = 256;  // taps a piece (texture_bwd_cuda.PIECE)
constexpr int WARPS = 4;
constexpr int BLOCK = 32 * WARPS;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Row (dv) and column (du) weight factors of one tap, lattice_setup_sep.
__device__ __forceinline__ void tap_factors(float u, float v, int hl, int wl, int boundary,
                                            int dv, int du, float& vw, float& uw) {
    const float w = static_cast<float>(wl);
    const float h = static_cast<float>(hl);
    if (boundary == WRAP) {
        u = u - floorf(u);
        v = v - floorf(v);
    }
    u = u * w - 0.5f;
    v = v * h - 0.5f;
    if (boundary == CLAMP) {
        u = clip_nan(u, 0.0f, w - 1.0f);
        v = clip_nan(v, 0.0f, h - 1.0f);
    }
    const int ju = static_cast<int>(floorf(u));
    const int jv = static_cast<int>(floorf(v));
    const float fu = u - static_cast<float>(ju);
    const float fv = v - static_cast<float>(jv);
    vw = dv == 0 ? 1.0f - fv : fv;
    uw = du == 0 ? 1.0f - fu : fu;
    if (boundary == ZERO) {
        const int r = jv + dv, c = ju + du;
        vw = vw * ((r >= 0 && r < hl) ? 1.0f : 0.0f);
        uw = uw * ((c >= 0 && c < wl) ? 1.0f : 0.0f);
    }
}

template <int C>
__global__ void __launch_bounds__(BLOCK)
tex_grad_pieces(const int* __restrict__ codes, const int* __restrict__ off,
                const int* __restrict__ first, const float* __restrict__ u,
                const float* __restrict__ v, const float* __restrict__ flevel,
                const float* __restrict__ gc, double* __restrict__ partial, int n_texels,
                int n_pieces, int N, int L, int filter, int boundary, Levels lv) {
    const int piece = blockIdx.x * WARPS + threadIdx.x / 32;  // uniform over the warp
    const int lane = threadIdx.x % 32;
    if (piece >= n_pieces) return;
    // The texel owning this piece: the last t with first[t] <= piece.
    int lo = 0, hi = n_texels;
    while (hi - lo > 1) {
        const int mid = (lo + hi) / 2;
        if (first[mid] <= piece) lo = mid; else hi = mid;
    }
    const int e0 = off[lo] + (piece - first[lo]) * PIECE;
    const int e1 = min(e0 + PIECE, off[lo + 1]);

    double acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0;
    for (int e = e0 + lane; e < e1; e += 32) {
        const int code = codes[e];
        const int tap = code / N;
        const int p = code - tap * N;
        const int s = tap >> 2, dv = (tap >> 1) & 1, du = tap & 1;
        int l0, l1;
        float frac;
        level_weights(filter != LINEAR ? flevel[p] : 0.0f, L, filter, l0, l1, frac);
        const int lev = s == 0 ? l0 : l1;
        const float lw = filter == MIP_LINEAR ? (s == 0 ? 1.0f - frac : frac) : 1.0f;
        float vw, uw;
        tap_factors(u[p], v[p], lv.h[lev], lv.w[lev], boundary, dv, du, vw, uw);
        const float lwv = lw * vw;
#pragma unroll
        for (int c = 0; c < C; ++c)
            acc[c] += static_cast<double>((lwv * gc[static_cast<size_t>(c) * N + p]) * uw);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const double t = warp_sum(acc[c]);
        if (lane == 0) partial[static_cast<size_t>(piece) * C + c] = t;
    }
}

template <int C>
__global__ void __launch_bounds__(BLOCK)
tex_grad_texels(const int* __restrict__ first, const double* __restrict__ partial,
                float* __restrict__ out, int n_texels) {
    const int t = blockIdx.x * WARPS + threadIdx.x / 32;  // uniform over the warp
    const int lane = threadIdx.x % 32;
    if (t >= n_texels) return;
    double acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0;
    const int k1 = first[t + 1];
    for (int k = first[t] + lane; k < k1; k += 32) {
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += partial[static_cast<size_t>(k) * C + c];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const double s = warp_sum(acc[c]);
        if (lane == 0) out[static_cast<size_t>(t) * C + c] = static_cast<float>(s);
    }
}

}  // namespace

// codes [M] sorted tap codes, off [n_texels+1] their texel segments,
// first [n_texels+1] the first piece of each texel (n_pieces in all);
// u, v, flevel [N], gc [C, N] float32; meta as nvdr_texture_fwd ->
// partial [max(n_pieces, 1), C] float64 scratch, out [n_texels, C]
// float32. N = B*H*W (B, H, W and per_image only shape the checks: the
// texel is the key). 1 <= C <= 8.
extern "C" int nvdr_texture_grad(const int* codes, const int* off, const int* first,
                                 const float* u, const float* v, const float* flevel,
                                 const float* gc, const int* meta, double* partial, float* out,
                                 int n_texels, int n_pieces, int B, int H, int W, int C, int L,
                                 int per_image, int boundary, int filter, void* stream) {
    (void)per_image;
    if (n_texels <= 0) return static_cast<int>(cudaGetLastError());
    if (L < 1 || L > MAX_LEVELS || boundary < 0 || boundary > 2 || filter < 0 || filter > 2 ||
        B <= 0 || H <= 0 || W <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const Levels lv = levels_from_meta(meta, L);
    const int N = B * H * W;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int grid1 = (n_pieces + WARPS - 1) / WARPS;
    const int grid2 = (n_texels + WARPS - 1) / WARPS;
#define NVDR_TEX_GRAD_CASE(n)                                                                \
    case n:                                                                                  \
        if (n_pieces > 0)                                                                    \
            tex_grad_pieces<n><<<grid1, BLOCK, 0, s>>>(codes, off, first, u, v, flevel, gc,  \
                                                       partial, n_texels, n_pieces, N, L,    \
                                                       filter, boundary, lv);                \
        tex_grad_texels<n><<<grid2, BLOCK, 0, s>>>(first, partial, out, n_texels);           \
        break;
    switch (C) {
        NVDR_TEX_GRAD_CASE(1)
        NVDR_TEX_GRAD_CASE(2)
        NVDR_TEX_GRAD_CASE(3)
        NVDR_TEX_GRAD_CASE(4)
        NVDR_TEX_GRAD_CASE(5)
        NVDR_TEX_GRAD_CASE(6)
        NVDR_TEX_GRAD_CASE(7)
        NVDR_TEX_GRAD_CASE(8)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef NVDR_TEX_GRAD_CASE
    return static_cast<int>(cudaGetLastError());
}
