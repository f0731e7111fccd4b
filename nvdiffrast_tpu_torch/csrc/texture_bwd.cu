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
// Per slot s (slot 0 = level l0 with weight 1 - frac, slot 1 = level l1
// with weight frac for linear-mipmap-linear; one slot l0 with weight 1
// otherwise): the corner setup, the 4 corner gathers of C floats, masked
// by the zero boundary's validity for the derivatives, and
//   dqu = (1-fv)(q10-q00) + fv(q11-q01),  dqv = (1-fu)(q01-q00) + fu(q11-q10),
//   val = the slot's bilinear value,
//   gu += lw * sum_c gc_c dqu_c * w_l,  gv += lw * sum_c gc_c dqv_c * h_l,
//   gfl += sign_s * sum_c gc_c val_c   (sign -1, +1; trilinear only).
// Both slots run even where l1 == l0 (the top level): the reference adds
// slot 1 there too (gfl gets -val + val, gu the weights 1-frac and frac).
//
// Bound on the H100: device-memory traffic of the pixel streams (u, v,
// flevel and C colour cotangents read, 3 floats written: 9 words a pixel
// at C = 3); the corner gathers hit L1/L2. A thread that loads one
// pixel's streams and then gathers has little device-memory traffic in
// flight while it gathers, so:
//
// * Persistent CTAs (as many as fit on the card) walk tiles of T = 1,024
//   consecutive pixels, tile blockIdx.x + k * gridDim.x at step k, four
//   pixels a thread at a stride of 256 (coalesced rows). Each thread
//   loads the streams of its four pixels first, then gathers and computes
//   them one after the other, so one stream latency covers four pixels.
//   On the H100, one CTA a tile without the loop took 0.0725 ms a call
//   on the bench textured step's inputs, the loop 0.065.
// * Filter, boundary and C are template parameters: both slots' corner
//   setups come first, then all 8 x C gathers of a trilinear pixel, so
//   they pay one round of L1/L2 latency; the zero boundary's masks and
//   the slot loop are resolved at compile time.
// * The level table (off, h, w) is copied into shared memory once a CTA,
//   one 16-byte entry a level, so a warp whose pixels straddle levels
//   does not serialise on parameter reads.
//
// Rounding: built with -fmad=false in the reference's operation order;
// the plain twin (texture_bwd_plain) agrees to the last bit.
#include <cuda_runtime.h>

#include "texture_corner.cuh"

namespace {

using namespace nvdr_tex;

constexpr int NT = 256;      // threads a CTA
constexpr int PPT = 4;       // pixels a thread
constexpr int T = NT * PPT;  // pixels a CTA

// Streams a pixel reads: u, v, flevel (mip filters), C cotangents.
template <int C, int FILTER>
__host__ __device__ constexpr int n_streams() {
    return 2 + (FILTER != LINEAR ? 1 : 0) + C;
}

// (gu, gv, gfl) of one pixel from its streams s = (u, v, [flevel], gc_0..).
template <int C, int FILTER, int BOUNDARY>
__device__ __forceinline__ void pixel_grads(const float* __restrict__ tex, const int4* lv, int L,
                                            int tz, const float* s, float& gu, float& gv,
                                            float& gfl) {
    constexpr int SLOTS = FILTER == MIP_LINEAR ? 2 : 1;
    constexpr int G = FILTER != LINEAR ? 3 : 2;  // first cotangent stream
    const float up = s[0], vp = s[1];
    int l0, l1;
    float frac;
    level_weights(FILTER != LINEAR ? s[2] : 0.0f, L, FILTER, l0, l1, frac);

    Corners k[SLOTS];
    int4 t[SLOTS];  // (off, h, w) of the slot's level
    float q[SLOTS][4][C];
#pragma unroll
    for (int sl = 0; sl < SLOTS; ++sl) {
        t[sl] = lv[sl == 0 ? l0 : l1];
        k[sl] = corner_setup(t[sl].y, t[sl].z, up, vp, BOUNDARY);
    }
#pragma unroll
    for (int sl = 0; sl < SLOTS; ++sl) {
        const int base = t[sl].x + tz * t[sl].y * t[sl].z;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float* qj = tex + static_cast<size_t>(base + k[sl].idx[j]) * C;
#pragma unroll
            for (int c = 0; c < C; ++c) q[sl][j][c] = __ldg(qj + c);
        }
    }

    gu = 0.0f;
    gv = 0.0f;
    gfl = 0.0f;
#pragma unroll
    for (int sl = 0; sl < SLOTS; ++sl) {
        const Corners& kk = k[sl];
        const float lw = SLOTS == 1 ? 1.0f : (sl == 0 ? 1.0f - frac : frac);
        float du = 0.0f, dv = 0.0f, dval = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            float a = q[sl][0][c], bq = q[sl][1][c], cq = q[sl][2][c], d = q[sl][3][c];
            const float val = ((kk.w[0] * a + kk.w[1] * bq) + kk.w[2] * cq) + kk.w[3] * d;
            if (BOUNDARY == ZERO) {  // invalid corners: 0 in the derivatives
                a = a * kk.ok[0];
                bq = bq * kk.ok[1];
                cq = cq * kk.ok[2];
                d = d * kk.ok[3];
            }
            const float dqu = (1.0f - kk.fv) * (bq - a) + kk.fv * (d - cq);
            const float dqv = (1.0f - kk.fu) * (cq - a) + kk.fu * (d - bq);
            const float g = s[G + c];
            du = du + g * dqu;
            dv = dv + g * dqv;
            dval = dval + g * val;
        }
        gu = gu + lw * du * static_cast<float>(t[sl].z);
        gv = gv + lw * dv * static_cast<float>(t[sl].y);
        if (SLOTS == 2) gfl = gfl + (sl == 0 ? -1.0f : 1.0f) * dval;
    }
}

struct Args {
    const float* tex;
    const float* u;
    const float* v;
    const float* flevel;
    const float* gc;
    float* out;
    int HW, N, L, per_image;
    Levels lv;
};

// Base of stream s: u, v, [flevel], then the cotangent rows.
template <int C, int FILTER>
__device__ __forceinline__ const float* stream_base(const Args& a, int s) {
    constexpr int G = FILTER != LINEAR ? 3 : 2;
    if (s == 0) return a.u;
    if (s == 1) return a.v;
    if (s < G) return a.flevel;
    return a.gc + static_cast<size_t>(s - G) * a.N;
}

template <int C, int FILTER, int BOUNDARY>
__global__ void __launch_bounds__(NT) tex_bwd_kernel(const Args a) {
    constexpr int NS = n_streams<C, FILTER>();
    __shared__ int4 lv[MAX_LEVELS];
    const int tid = threadIdx.x;
    if (tid < a.L) lv[tid] = make_int4(a.lv.off[tid], a.lv.h[tid], a.lv.w[tid], 0);
    __syncthreads();

    for (int tile = blockIdx.x; tile * T < a.N; tile += gridDim.x) {
        const int p0 = tile * T + tid;
        float s[PPT][NS];
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
            const int p = p0 + i * NT;
#pragma unroll
            for (int j = 0; j < NS; ++j)
                s[i][j] = p < a.N ? stream_base<C, FILTER>(a, j)[p] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
            const int p = p0 + i * NT;
            if (p >= a.N) break;
            const int tz = a.per_image ? p / a.HW : 0;
            float gu, gv, gfl;
            pixel_grads<C, FILTER, BOUNDARY>(a.tex, lv, a.L, tz, s[i], gu, gv, gfl);
            a.out[p] = gu;
            a.out[static_cast<size_t>(a.N) + p] = gv;
            a.out[2 * static_cast<size_t>(a.N) + p] = gfl;
        }
    }
}

// CTAs of one instantiation that fit on the card at once, asked of the
// CUDA runtime at its first launch in the process (the grid only spreads
// the tiles: any size gives the same results).
template <int C, int FILTER, int BOUNDARY>
int resident_ctas() {
    int dev = 0, n_sm = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tex_bwd_kernel<C, FILTER, BOUNDARY>,
                                                  NT, 0);
    return per_sm * n_sm > 0 ? per_sm * n_sm : 1;
}

template <int C, int FILTER, int BOUNDARY>
int launch(const Args& a, cudaStream_t stream) {
    static const int resident = resident_ctas<C, FILTER, BOUNDARY>();
    const int n_tiles = (a.N + T - 1) / T;
    tex_bwd_kernel<C, FILTER, BOUNDARY>
        <<<n_tiles < resident ? n_tiles : resident, NT, 0, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

template <int C, int FILTER>
int launch_boundary(const Args& a, int boundary, cudaStream_t s) {
    switch (boundary) {
        case WRAP: return launch<C, FILTER, WRAP>(a, s);
        case CLAMP: return launch<C, FILTER, CLAMP>(a, s);
        default: return launch<C, FILTER, ZERO>(a, s);
    }
}

template <int C>
int launch_filter(const Args& a, int filter, int boundary, cudaStream_t s) {
    switch (filter) {
        case LINEAR: return launch_boundary<C, LINEAR>(a, boundary, s);
        case MIP_NEAREST: return launch_boundary<C, MIP_NEAREST>(a, boundary, s);
        default: return launch_boundary<C, MIP_LINEAR>(a, boundary, s);
    }
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
    Args a;
    a.tex = tex;
    a.u = u;
    a.v = v;
    a.flevel = flevel;
    a.gc = gc;
    a.out = out;
    a.HW = H * W;
    a.N = B * H * W;
    a.L = L;
    a.per_image = per_image;
    a.lv = levels_from_meta(meta, L);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (C) {
        case 1: return launch_filter<1>(a, filter, boundary, s);
        case 2: return launch_filter<2>(a, filter, boundary, s);
        case 3: return launch_filter<3>(a, filter, boundary, s);
        case 4: return launch_filter<4>(a, filter, boundary, s);
        case 5: return launch_filter<5>(a, filter, boundary, s);
        case 6: return launch_filter<6>(a, filter, boundary, s);
        case 7: return launch_filter<7>(a, filter, boundary, s);
        case 8: return launch_filter<8>(a, filter, boundary, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
