// Fused interpolate + antialias forward of the render pipeline.
//
// Replaces: nvdiffrast_tpu/ops/pipeline_pallas.py, shade_fwd.
//
// One thread per pixel. Each thread reads its own and its right and
// down neighbours' (id, z/w, b0, b1) straight from the rasterizer's
// flat buffers (borders fold onto the pixel itself, which disables the
// pair), gathers the attribute table [3A, R+1] and the AA forward table
// [7, R+1] by triangle row with plain global loads, and computes:
//   c0   = the interpolated colour (bary combine of the gathered rows);
//   the AA pair analysis on both axes (closer-triangle pick, silhouette
//   bits, rational edge argmax, crossing point, 1/16-px epsilon);
//   out  = c0 plus the pair contributions that land on this pixel;
//   negx/negy = contributions that land on the right/down neighbour
//   (added by the caller, in the reference's order, without atomics);
//   al0, ax0, al1, ax1 = the per-axis alpha and (edge + 4*is_t1), the
//   residuals the backward consumes where alpha != 0.
// The TPU kernel's lane-gather sweep (_masked_gather) is a VMEM
// workaround with no counterpart here.
//
// Bound on the H100: device-memory traffic. Per pixel it reads 3x4
// floats of raster buffers and writes (4A + 4) floats; the table rows
// (R+1 columns, a few hundred KB) stay in L2/L1. Later work: shared
// memory tiles for the neighbour reads, and fusing the neighbour adds.
//
// Rounding: built with -fmad=false; every expression keeps the
// reference's operation order, so the plain twin (shade_cols_plain)
// agrees to the last bit.
#include <cuda_runtime.h>

#include "aa_pair.cuh"

namespace {

using nvdr_aa::pair_alpha;
using nvdr_aa::pair_ids;

constexpr int BLOCK = 256;

// c = (b0*g[a] + b1*g[A+a]) + b2*g[2A+a] for every channel.
template <int A>
__device__ __forceinline__ void combine(const float* g, float b0, float b1, float b2,
                                        float* c) {
#pragma unroll
    for (int a = 0; a < A; ++a) c[a] = (b0 * g[a] + b1 * g[A + a]) + b2 * g[2 * A + a];
}

template <int A>
__device__ __forceinline__ void gather(const float* __restrict__ tbl, int cols, int row,
                                       float* g) {
#pragma unroll
    for (int k = 0; k < 3 * A; ++k) g[k] = tbl[static_cast<size_t>(k) * cols + row];
}

template <int A, int D>
__device__ __forceinline__ void axis(const float* __restrict__ atbl,
                                     const float* __restrict__ ftbl, int cols,
                                     const float* __restrict__ b0, const float* __restrict__ b1,
                                     const float* __restrict__ zw,
                                     const float* __restrict__ idf, int p, int q, int N, int T,
                                     int ro, float id0, float z0, float fx, float fy,
                                     const float* c0, float* out, float* __restrict__ neg,
                                     float* __restrict__ al, float* __restrict__ ax) {
    // Triangle choice for the pair (antialias.pair_ids).
    const float id1 = idf[q];
    const int tri1 = static_cast<int>(id1) - 1;
    int tsel;
    bool is_t1, active;
    pair_ids(id0, id1, z0, zw[q], T, tsel, is_t1, active);

    float t7[7];
#pragma unroll
    for (int k = 0; k < 7; ++k)
        t7[k] = active ? ftbl[static_cast<size_t>(k) * cols + tsel + ro] : 0.0f;
    float alpha;
    int di;
    pair_alpha<D>(t7, fx, fy, is_t1, active, alpha, di);

    // Neighbour colour: the neighbour pixel's own interpolation.
    const bool nvalid = (tri1 >= 0) && (tri1 < T);
    float g[3 * A];
    if (active && nvalid) {
        gather<A>(atbl, cols, tri1 + ro, g);
    } else {
#pragma unroll
        for (int k = 0; k < 3 * A; ++k) g[k] = 0.0f;
    }
    const float nb0 = nvalid ? b0[q] : 0.0f;
    const float nb1 = nvalid ? b1[q] : 0.0f;
    const float nb2 = nvalid ? (1.0f - b0[q]) - b1[q] : 0.0f;
    float c1[A];
    combine<A>(g, nb0, nb1, nb2, c1);
    const bool apos = alpha > 0.0f;
#pragma unroll
    for (int a = 0; a < A; ++a) {
        const float contrib = alpha * (c1[a] - c0[a]);
        out[a] = out[a] + (apos ? contrib : 0.0f);
        neg[static_cast<size_t>(a) * N + p] = apos ? 0.0f : contrib;
    }
    al[p] = alpha;
    ax[p] = static_cast<float>(di) + 4.0f * (is_t1 ? 1.0f : 0.0f);
}

template <int A>
__global__ void __launch_bounds__(BLOCK)
shade_fwd_kernel(const float* __restrict__ atbl, const float* __restrict__ ftbl, int cols,
                 const float* __restrict__ b0, const float* __restrict__ b1,
                 const float* __restrict__ zw, const float* __restrict__ idf,
                 float* __restrict__ out_own, float* __restrict__ c0_out,
                 float* __restrict__ negx, float* __restrict__ negy, float* __restrict__ al0,
                 float* __restrict__ ax0, float* __restrict__ al1, float* __restrict__ ax1,
                 int N, int T, int H, int W, float fxo, float fyo) {
    const int p = blockIdx.x * BLOCK + threadIdx.x;
    if (p >= N) return;
    const int col = p % W;
    const int row = (p / W) % H;
    const int ro = (p / (H * W)) * T;  // instance row offset b*T
    const float fx = static_cast<float>(col) + fxo;
    const float fy = static_cast<float>(row) + fyo;

    // Interpolate: own-pixel colour.
    const float id0 = idf[p];
    const float z0 = zw[p];
    const int tid0 = static_cast<int>(id0) - 1;
    const bool valid = (tid0 >= 0) && (tid0 < T);
    float c0[A], out[A];
    if (valid) {
        float g[3 * A];
        gather<A>(atbl, cols, tid0 + ro, g);
        combine<A>(g, b0[p], b1[p], (1.0f - b0[p]) - b1[p], c0);
    } else {
#pragma unroll
        for (int a = 0; a < A; ++a) c0[a] = 0.0f;
    }
#pragma unroll
    for (int a = 0; a < A; ++a) out[a] = c0[a];

    // Antialias, both axes (borders fold onto the pixel itself).
    const int qx = (col >= W - 1) ? p : p + 1;
    const int qy = (row >= H - 1) ? p : p + W;
    axis<A, 0>(atbl, ftbl, cols, b0, b1, zw, idf, p, qx, N, T, ro, id0, z0, fx, fy, c0, out,
               negx, al0, ax0);
    axis<A, 1>(atbl, ftbl, cols, b0, b1, zw, idf, p, qy, N, T, ro, id0, z0, fx, fy, c0, out,
               negy, al1, ax1);
#pragma unroll
    for (int a = 0; a < A; ++a) {
        out_own[static_cast<size_t>(a) * N + p] = out[a];
        c0_out[static_cast<size_t>(a) * N + p] = c0[a];
    }
}

template <int A>
void launch(const float* atbl, const float* ftbl, int cols, const float* b0, const float* b1,
            const float* zw, const float* idf, float* out, float* c0, float* negx, float* negy,
            float* al0, float* ax0, float* al1, float* ax1, int N, int T, int H, int W,
            float fxo, float fyo, cudaStream_t stream) {
    const int grid = (N + BLOCK - 1) / BLOCK;
    shade_fwd_kernel<A><<<grid, BLOCK, 0, stream>>>(atbl, ftbl, cols, b0, b1, zw, idf, out, c0,
                                                    negx, negy, al0, ax0, al1, ax1, N, T, H, W,
                                                    fxo, fyo);
}

}  // namespace

// atbl [3A, cols], ftbl [7, cols] (cols = B*T + 1); b0, b1, zw, idf [N];
// out, c0, negx, negy [A, N]; al0, ax0, al1, ax1 [N]. 1 <= A <= 8.
extern "C" int nvdr_shade_fwd(const float* atbl, const float* ftbl, int cols, const float* b0,
                              const float* b1, const float* zw, const float* idf, float* out,
                              float* c0, float* negx, float* negy, float* al0, float* ax0,
                              float* al1, float* ax1, int N, int A, int T, int H, int W,
                              float fxo, float fyo, void* stream) {
    if (N <= 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NVDR_SHADE_CASE(n)                                                                   \
    case n:                                                                                  \
        launch<n>(atbl, ftbl, cols, b0, b1, zw, idf, out, c0, negx, negy, al0, ax0, al1, ax1, \
                  N, T, H, W, fxo, fyo, s);                                                  \
        break;
    switch (A) {
        NVDR_SHADE_CASE(1)
        NVDR_SHADE_CASE(2)
        NVDR_SHADE_CASE(3)
        NVDR_SHADE_CASE(4)
        NVDR_SHADE_CASE(5)
        NVDR_SHADE_CASE(6)
        NVDR_SHADE_CASE(7)
        NVDR_SHADE_CASE(8)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef NVDR_SHADE_CASE
    return static_cast<int>(cudaGetLastError());
}
