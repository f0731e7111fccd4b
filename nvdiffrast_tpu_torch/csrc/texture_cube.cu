// Cube-map sampler, forward and backward: seamless bilinear and trilinear
// sampling of a flat-packed 6-face mip pyramid.
//
// Replaces: nvdiffrast_tpu/ops/texture_pallas.py, _call_cube (B12; kernel
// body _build_cube_kernel, with _face_dir_2d, _faceid_project_2d,
// _wrap_corner_2d and cube_corner_setup) in its modes "fwd" (cube_fwd)
// and "bwd" (cube_bwd), for the filters linear, linear-mipmap-nearest and
// linear-mipmap-linear.
//
// The pyramid is one texel-major buffer [n_texels, C]: level l's
// [D, 6, w, w] block starts at texel off[l], so the texel of (tz, face,
// iy, ix) is off + ((tz * 6 + face) * w + iy) * w + ix. The TPU kernel
// splits the levels between VMEM and HBM and gathers big levels through
// double-buffered windows (_split_levels, _gather_big); here the whole
// pyramid stays in device memory and neighbouring pixels' texels come
// from L1 and L2, as for texture_fwd.cu.
//
// One thread per pixel, 256 pixels a block, in row-major pixel order.
// Per pixel: the level pair (l0, l1) and blend weight (level_weights);
// for l0 and, where it differs, l1: the four corners of (s, t) on the
// level's face, each wrapped to the neighbour face through the cube
// geometry when it falls off the face (a texel centre is turned into a
// direction, which selects a face and projects back; the index rounds
// half to even, as jnp.round), a diagonal overflow at a cube corner
// marking the corner missing; the corner gathers of C floats; a missing
// corner replaced by the mean of the valid ones; and
//   fwd: out += wgt * (((w00*q00 + w10*q10) + w01*q01) + w11*q11),
//   bwd: gs += (wgt * sum_c dy_c dqu_c) * w_l, gt the same with dqv,
//        gfl += (on1 - on0) * sum_c dy_c val_c,
// levels in ascending order, as the reference's level loop. A pixel whose
// direction is invalid (finite == 0) gets zeros. The texture gradient is
// not here: the wrapper recomputes the taps' texels and effective weights
// and reduces them with scatter_rows.cu (B10), as _sample_cube_bwd does.
//
// Bound on the H100: device-memory traffic of the pixel streams (s, t,
// flevel, finite, face, tz read, C floats written, plus C cotangents read
// in the backward); the corner gathers (8 x C per pixel) hit L1/L2 and the
// seam wrap is ~60 float operations a corner.
//
// Rounding: built with -fmad=false; divisions are IEEE (no fast math);
// every expression keeps the reference's operation order, so the plain
// twins (ops/texture_cube_cuda.py sample_cube_plain, cube_bwd_plain)
// agree to the last bit.
#include <cuda_runtime.h>

#include "texture_corner.cuh"

namespace {

using namespace nvdr_tex;

constexpr int BLOCK = 256;

// Texel (s, t) on `face` -> direction (_face_dir_2d).
__device__ __forceinline__ void face_dir(int face, float s, float t, float& x, float& y,
                                         float& z) {
    const float du = 2.0f * (s - 0.5f);
    const float dv = 2.0f * (t - 0.5f);
    x = face == 0 ? 1.0f : (face == 1 ? -1.0f : (face == 5 ? -du : du));
    y = face == 2 ? 1.0f : (face == 3 ? -1.0f : -dv);
    z = face == 0 ? -du
                  : (face == 1 ? du
                               : (face == 2 ? dv : (face == 3 ? -dv : (face == 4 ? 1.0f : -1.0f))));
}

// Direction -> (face, s, t), unclipped (_faceid_project_2d). The
// directions here come from texel centres, so they are finite.
__device__ __forceinline__ void faceid_project(float x, float y, float z, int& face, float& s,
                                               float& t) {
    const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
    const bool z_major = az > fmaxf(ax, ay);
    const bool y_major = !z_major && (ay > ax);
    const bool x_major = !(z_major || y_major);
    const float c = z_major ? z : (y_major ? y : x);
    face = (z_major ? 4 : (y_major ? 2 : 0)) + (c < 0.0f ? 1 : 0);
    const float u_in = x_major ? z : x;
    const float v_in = y_major ? z : y;
    const float m = 0.5f / (fabsf(c) > 0.0f ? fabsf(c) : 1.0f);
    const float m0 = (face == 0 || face == 5) ? -m : m;
    const float m1 = face == 2 ? m : -m;
    s = u_in * m0 + 0.5f;
    t = v_in * m1 + 0.5f;
}

// A corner (ix, iy) of `face` that may lie one texel outside it ->
// (row face*w + iy, column, validity) (_wrap_corner_2d).
__device__ __forceinline__ void wrap_corner(int face, int ix, int iy, int w, int& row, int& col,
                                            float& ok) {
    const bool ix_out = ix < 0 || ix >= w;
    const bool iy_out = iy < 0 || iy >= w;
    ok = (ix_out && iy_out) ? 0.0f : 1.0f;
    if (!(ix_out || iy_out)) {
        row = face * w + iy;
        col = ix;
        return;
    }
    const float wf = static_cast<float>(w);
    const float s = (static_cast<float>(ix) + 0.5f) / wf;
    const float t = (static_cast<float>(iy) + 0.5f) / wf;
    float x, y, z, s2, t2;
    int nface;
    face_dir(face, s, t, x, y, z);
    faceid_project(x, y, z, nface, s2, t2);
    const int nix = clampi(static_cast<int>(rintf(s2 * wf - 0.5f)), 0, w - 1);
    const int niy = clampi(static_cast<int>(rintf(t2 * wf - 0.5f)), 0, w - 1);
    row = nface * w + niy;
    col = nix;
}

// Corners of one level (cube_corner_setup): texel ids relative to the
// level's texture block, validity, fractions and weights (no validity).
struct CubeCorners {
    int idx[4];
    float ok[4];
    float fu, fv;
    float w[4];
};

__device__ __forceinline__ CubeCorners cube_corners(float s, float t, int face, int wl) {
    const float w = static_cast<float>(wl);
    const float u = s * w - 0.5f;
    const float v = t * w - 0.5f;
    const int iu0 = static_cast<int>(floorf(u));
    const int iv0 = static_cast<int>(floorf(v));
    CubeCorners k;
    k.fu = u - static_cast<float>(iu0);
    k.fv = v - static_cast<float>(iv0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        int row, col;
        wrap_corner(face, iu0 + (j & 1), iv0 + (j >> 1), wl, row, col, k.ok[j]);
        k.idx[j] = row * wl + col;
    }
    const float gu = 1.0f - k.fu;
    const float gv = 1.0f - k.fv;
    k.w[0] = gu * gv;
    k.w[1] = k.fu * gv;
    k.w[2] = gu * k.fv;
    k.w[3] = k.fu * k.fv;
    return k;
}

// The four corner texels of every channel, a missing one replaced by the
// mean of the valid ones (the average-of-3 rule).
template <int C>
__device__ __forceinline__ void filled_corners(const float* __restrict__ tex, int base,
                                               const CubeCorners& k, float (&qq)[4][C]) {
    const float n_ok = fmaxf(((k.ok[0] + k.ok[1]) + k.ok[2]) + k.ok[3], 1.0f);
#pragma unroll
    for (int c = 0; c < C; ++c) {
        float q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) q[j] = __ldg(tex + static_cast<size_t>(base + k.idx[j]) * C + c);
        const float avg =
            (((k.ok[0] * q[0] + k.ok[1] * q[1]) + k.ok[2] * q[2]) + k.ok[3] * q[3]) / n_ok;
#pragma unroll
        for (int j = 0; j < 4; ++j) qq[j][c] = k.ok[j] > 0.0f ? q[j] : avg;
    }
}

template <int C, bool BWD>
__global__ void __launch_bounds__(BLOCK)
cube_kernel(const float* __restrict__ tex, const float* __restrict__ s,
            const float* __restrict__ t, const float* __restrict__ flevel,
            const int* __restrict__ finite, const int* __restrict__ face,
            const int* __restrict__ tz, const float* __restrict__ dy, float* __restrict__ out,
            int N, int L, int filter, Levels lv) {
    const int p = blockIdx.x * BLOCK + threadIdx.x;
    if (p >= N) return;
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    float gs = 0.0f, gt = 0.0f, gfl = 0.0f;
    if (finite[p] != 0) {
        const float sp = s[p], tp = t[p];
        const int fp = face[p], zp = tz[p];
        int l0, l1;
        float frac;
        level_weights(filter != LINEAR ? flevel[p] : 0.0f, L, filter, l0, l1, frac);
        float g[C];
        if (BWD) {
#pragma unroll
            for (int c = 0; c < C; ++c) g[c] = dy[static_cast<size_t>(c) * N + p];
        }
        for (int j = 0; j < 2; ++j) {
            const int lev = j == 0 ? l0 : l1;
            if (j == 1 && l1 == l0) break;
            const bool on0 = lev == l0, on1 = lev == l1;
            const float wgt = (on0 ? 1.0f - frac : 0.0f) + (on1 ? frac : 0.0f);
            const int wl = lv.w[lev];
            const CubeCorners k = cube_corners(sp, tp, fp, wl);
            float qq[4][C];
            filled_corners<C>(tex, lv.off[lev] + zp * (6 * wl * wl), k, qq);
            if (!BWD) {
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    const float val =
                        ((k.w[0] * qq[0][c] + k.w[1] * qq[1][c]) + k.w[2] * qq[2][c]) +
                        k.w[3] * qq[3][c];
                    acc[c] = acc[c] + wgt * val;
                }
            } else {
                float gu = 0.0f, gv = 0.0f, gl = 0.0f;
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    const float dqu = (1.0f - k.fv) * (qq[1][c] - qq[0][c]) +
                                      k.fv * (qq[3][c] - qq[2][c]);
                    const float dqv = (1.0f - k.fu) * (qq[2][c] - qq[0][c]) +
                                      k.fu * (qq[3][c] - qq[1][c]);
                    const float val =
                        ((k.w[0] * qq[0][c] + k.w[1] * qq[1][c]) + k.w[2] * qq[2][c]) +
                        k.w[3] * qq[3][c];
                    gu = gu + g[c] * dqu;
                    gv = gv + g[c] * dqv;
                    gl = gl + g[c] * val;
                }
                const float wf = static_cast<float>(wl);
                gs = gs + wgt * gu * wf;
                gt = gt + wgt * gv * wf;
                gfl = gfl + ((on1 ? 1.0f : 0.0f) - (on0 ? 1.0f : 0.0f)) * gl;
            }
        }
    }
    if (!BWD) {
#pragma unroll
        for (int c = 0; c < C; ++c) out[static_cast<size_t>(c) * N + p] = acc[c];
    } else {
        out[p] = gs;
        out[static_cast<size_t>(N) + p] = gt;
        out[2 * static_cast<size_t>(N) + p] = gfl;
    }
}

template <bool BWD>
int launch(const float* tex, const float* s, const float* t, const float* flevel,
           const int* finite, const int* face, const int* tz, const float* dy, float* out,
           const int* meta, int N, int C, int L, int filter, void* stream) {
    if (N <= 0) return static_cast<int>(cudaGetLastError());
    if (L < 1 || L > MAX_LEVELS || filter < 0 || filter > 2)
        return static_cast<int>(cudaErrorInvalidValue);
    const Levels lv = levels_from_meta(meta, L);
    const dim3 grid((N + BLOCK - 1) / BLOCK);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NVDR_CUBE_CASE(n)                                                                  \
    case n:                                                                                \
        cube_kernel<n, BWD><<<grid, BLOCK, 0, st>>>(tex, s, t, flevel, finite, face, tz,   \
                                                    dy, out, N, L, filter, lv);            \
        break;
    switch (C) {
        NVDR_CUBE_CASE(1)
        NVDR_CUBE_CASE(2)
        NVDR_CUBE_CASE(3)
        NVDR_CUBE_CASE(4)
        NVDR_CUBE_CASE(5)
        NVDR_CUBE_CASE(6)
        NVDR_CUBE_CASE(7)
        NVDR_CUBE_CASE(8)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef NVDR_CUBE_CASE
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tex [n_texels, C] texel-major pyramid of [D, 6, w, w, C] levels; s, t,
// flevel [N] float32 (flevel unread for filter 0); finite, face, tz [N]
// int32; out [C, N]. meta: L triples (off, w, w) in host memory. filter:
// 0 linear, 1 linear-mipmap-nearest, 2 linear-mipmap-linear. 1 <= C <= 8,
// 1 <= L <= 17.
extern "C" int nvdr_texture_cube_fwd(const float* tex, const float* s, const float* t,
                                     const float* flevel, const int* finite, const int* face,
                                     const int* tz, float* out, const int* meta, int N, int C,
                                     int L, int filter, void* stream) {
    return launch<false>(tex, s, t, flevel, finite, face, tz, nullptr, out, meta, N, C, L,
                         filter, stream);
}

// As nvdr_texture_cube_fwd, with dy [C, N] the cotangent of the samples;
// out [3, N] = (gs, gt, gfl).
extern "C" int nvdr_texture_cube_bwd(const float* tex, const float* s, const float* t,
                                     const float* flevel, const int* finite, const int* face,
                                     const int* tz, const float* dy, float* out,
                                     const int* meta, int N, int C, int L, int filter,
                                     void* stream) {
    return launch<true>(tex, s, t, flevel, finite, face, tz, dy, out, meta, N, C, L, filter,
                        stream);
}
