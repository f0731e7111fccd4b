// Backward of the render pipeline, per pixel: antialias + interpolate +
// rasterize in one pass.
//
// Replaces: nvdiffrast_tpu/ops/pipeline_pallas.py, pipeline_bwd.
//
// One thread per pixel p (flat index over B*H*W). Each thread reads its
// own loss gradient dy, its pre-AA colour c0 and the AA residuals
// (alpha, aux) of both axes, and the neighbour values it needs straight
// from the flat buffers: p+1 and p+W for the pair it owns (borders fold
// onto p itself, which disables the pair), p-1 and p-W for the pairs
// that land on it (zero before the first pixel). It computes:
//   gc  = the post-AA colour gradient: dy minus the pixel's own pair
//         blends plus the blends its left and upper neighbours' pairs
//         put on it, added as ((dy - v0) - v1) + v0[p-1] + v1[p-W];
//   dd2 = per axis the colour-dot weight of the pair, kept where the
//         pair's triangle is real, dd != 0 and |alpha| < 0.5;
//   rid2 = per axis the pair triangle's table row;
//   gs  = gc (the attribute gradient weights, expanded by the bary
//         outer product in grad_scatter.cu) and the rasterize backward's
//         9 clip-space vertex columns from the bary gradients, with the
//         copysign(1e-6) area epsilon and non-finite values zeroed.
// The TPU kernel's [rows, 128] blocks, edge padding and materialised
// shifted copies (_flatpad, _shifts, _roll_next_last) have no
// counterpart: neighbour reads are plain global loads. Table rows of
// atbl [3A, R+1] and vtbl [9, R+1] are gathered with plain loads too.
//
// Bound on the H100: device-memory traffic. Per pixel it reads
// (5 + 2A) floats and writes (A + 13) words; neighbour reads hit L1/L2,
// the tables (a few hundred KB) stay in L2.
//
// Rounding: built with -fmad=false; every expression keeps the
// reference's operation order, so the plain twin (pipeline_bwd_plain)
// agrees to the last bit.
#include <cuda_runtime.h>

#include "aa_pair.cuh"

namespace {

constexpr int BLOCK = 256;

// One AA axis: colour-gradient update, pair row and colour-dot weight.
template <int A>
__device__ __forceinline__ void aa_axis(int d, int p, int q, int N, int T, int ro, float id0,
                                        float al, float ax, const float* __restrict__ idf,
                                        const float* __restrict__ c0,
                                        const float* __restrict__ dy, const float* dy0,
                                        const float* c0p, float* gc, float* __restrict__ dd2,
                                        int* __restrict__ rid2) {
    int rid;
    float kept;
    nvdr_aa::bwd_axis<A>(q, N, T, ro, id0, al, ax, idf, c0, dy, dy0, c0p, gc, rid, kept);
    rid2[static_cast<size_t>(d) * N + p] = rid;
    dd2[static_cast<size_t>(d) * N + p] = kept;
}

template <int A>
__global__ void __launch_bounds__(BLOCK)
pipeline_bwd_kernel(const float* __restrict__ atbl, const float* __restrict__ vtbl, int cols,
                    const float* __restrict__ idf, const float* __restrict__ al0,
                    const float* __restrict__ ax0, const float* __restrict__ al1,
                    const float* __restrict__ ax1, const float* __restrict__ c0,
                    const float* __restrict__ dy, float* __restrict__ gs,
                    float* __restrict__ dd2, int* __restrict__ rid2, int N, int T, int H, int W,
                    float fxo, float fyo, float xs, float ys) {
    const int p = blockIdx.x * BLOCK + threadIdx.x;
    if (p >= N) return;
    const int col = p % W;
    const int row = (p / W) % H;
    const int ro = (p / (H * W)) * T;  // instance row offset b*T
    const float id0 = idf[p];

    float dy0[A], c0p[A], gc[A];
#pragma unroll
    for (int a = 0; a < A; ++a) {
        dy0[a] = dy[static_cast<size_t>(a) * N + p];
        c0p[a] = c0[static_cast<size_t>(a) * N + p];
        gc[a] = dy0[a];
    }

    // AA backward, both axes (borders fold onto the pixel itself).
    const int qx = (col >= W - 1) ? p : p + 1;
    const int qy = (row >= H - 1) ? p : p + W;
    aa_axis<A>(0, p, qx, N, T, ro, id0, al0[p], ax0[p], idf, c0, dy, dy0, c0p, gc, dd2, rid2);
    aa_axis<A>(1, p, qy, N, T, ro, id0, al1[p], ax1[p], idf, c0, dy, dy0, c0p, gc, dd2, rid2);

    // Blends the left (p-1) and upper (p-W) neighbours' pairs put here.
    const float a0m = p >= 1 ? al0[p - 1] : 0.0f;
    const float a1m = p >= W ? al1[p - W] : 0.0f;
#pragma unroll
    for (int a = 0; a < A; ++a) {
        const float dm1 = p >= 1 ? dy[static_cast<size_t>(a) * N + p - 1] : 0.0f;
        const float dmW = p >= W ? dy[static_cast<size_t>(a) * N + p - W] : 0.0f;
        const float vm0 = a0m * (a0m > 0.0f ? dm1 : dy0[a]);
        const float vm1 = a1m * (a1m > 0.0f ? dmW : dy0[a]);
        gc[a] = gc[a] + vm0 + vm1;
    }

    // Interpolate backward: bary gradients from the attribute rows.
    const int tid0 = static_cast<int>(id0) - 1;
    if (tid0 < 0 || tid0 >= T) {
#pragma unroll
        for (int k = 0; k < A + 9; ++k) gs[static_cast<size_t>(k) * N + p] = 0.0f;
        return;
    }
    const int r = tid0 + ro;
    float gb0 = 0.0f, gb1 = 0.0f;
#pragma unroll
    for (int a = 0; a < A; ++a) {
        const float g0 = atbl[static_cast<size_t>(a) * cols + r];
        const float g1 = atbl[static_cast<size_t>(A + a) * cols + r];
        const float g2 = atbl[static_cast<size_t>(2 * A + a) * cols + r];
        gb0 = gb0 + gc[a] * (g0 - g2);
        gb1 = gb1 + gc[a] * (g1 - g2);
        gs[static_cast<size_t>(a) * N + p] = gc[a];
    }

    // Rasterize backward (no db): clip-space vertex gradients.
    float t9[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) t9[k] = vtbl[static_cast<size_t>(k) * cols + r];
    const float x0 = t9[0], y0 = t9[1], w0 = t9[2];
    const float x1 = t9[3], y1 = t9[4], w1 = t9[5];
    const float x2 = t9[6], y2 = t9[7], w2 = t9[8];
    const float fxc = (static_cast<float>(col) + fxo) * xs;  // pixel centre in clip space
    const float fyc = (static_cast<float>(row) + fyo) * ys;
    const float p0x = x0 - fxc * w0, p0y = y0 - fyc * w0;
    const float p1x = x1 - fxc * w1, p1y = y1 - fyc * w1;
    const float p2x = x2 - fxc * w2, p2y = y2 - fyc * w2;
    const float a0 = p1x * p2y - p1y * p2x;
    const float a1 = p2x * p0y - p2y * p0x;
    const float a2 = p0x * p1y - p0y * p1x;
    const float at = a0 + a1 + a2;
    const float ep = at >= 0.0f ? 1e-6f : -1e-6f;
    const float iw = 1.0f / (at + ep);
    const float rb0 = a0 * iw;
    const float rb1 = a1 * iw;
    const float gB0 = gb0 * iw;
    const float gB1 = gb1 * iw;
    const float gbb = gB0 * rb0 + gB1 * rb1;
    const float gp0x = gbb * (p2y - p1y) - gB1 * p2y;
    const float gp1x = gbb * (p0y - p2y) + gB0 * p2y;
    const float gp2x = gbb * (p1y - p0y) - gB0 * p1y + gB1 * p0y;
    const float gp0y = gbb * (p1x - p2x) + gB1 * p2x;
    const float gp1y = gbb * (p2x - p0x) - gB0 * p2x;
    const float gp2y = gbb * (p0x - p1x) + gB0 * p1x - gB1 * p0x;
    const float g9[9] = {gp0x, gp0y, -fxc * gp0x - fyc * gp0y,
                         gp1x, gp1y, -fxc * gp1x - fyc * gp1y,
                         gp2x, gp2y, -fxc * gp2x - fyc * gp2y};
#pragma unroll
    for (int k = 0; k < 9; ++k)
        gs[static_cast<size_t>(A + k) * N + p] = isfinite(g9[k]) ? g9[k] : 0.0f;
}

}  // namespace

// atbl [3A, cols], vtbl [9, cols] (cols = B*T + 1); idf, al0, ax0,
// al1, ax1 [N]; c0, dy [A, N] -> gs [A+9, N], dd2 [2, N] float32,
// rid2 [2, N] int32. 1 <= A <= 8.
extern "C" int nvdr_pipeline_bwd(const float* atbl, const float* vtbl, int cols,
                                 const float* idf,
                                 const float* al0, const float* ax0, const float* al1,
                                 const float* ax1, const float* c0, const float* dy, float* gs,
                                 float* dd2, int* rid2, int N, int A, int T, int H, int W,
                                 float fxo, float fyo, float xs, float ys, void* stream) {
    if (N <= 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int grid = (N + BLOCK - 1) / BLOCK;
#define NVDR_BWD_CASE(n)                                                                      \
    case n:                                                                                   \
        pipeline_bwd_kernel<n><<<grid, BLOCK, 0, s>>>(atbl, vtbl, cols, idf, al0, ax0, al1, ax1, \
                                                      c0, dy, gs, dd2, rid2, N, T, H, W, fxo,  \
                                                      fyo, xs, ys);                           \
        break;
    switch (A) {
        NVDR_BWD_CASE(1)
        NVDR_BWD_CASE(2)
        NVDR_BWD_CASE(3)
        NVDR_BWD_CASE(4)
        NVDR_BWD_CASE(5)
        NVDR_BWD_CASE(6)
        NVDR_BWD_CASE(7)
        NVDR_BWD_CASE(8)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef NVDR_BWD_CASE
    return static_cast<int>(cudaGetLastError());
}
