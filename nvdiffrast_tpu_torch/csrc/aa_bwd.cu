// Antialias backward of a colour image on flat channel-major buffers.
//
// Replaces: nvdiffrast_tpu/ops/antialias_pallas.py, aa_backward_fused_cols
// (instance and range mode, viewport bands: RT, fyo as aa_fwd.cu, and
// pyh = 0.5 * the full image height for the clip-space scale).
//
// One thread per pixel p (flat index over B*H*W). Each thread reads its
// own loss gradient dy, colour and the AA residuals (alpha, aux) of both
// axes, and the neighbour values it needs straight from the flat buffers:
// p+1 and p+W for the pair it owns (borders fold onto p itself, which
// disables the pair), p-1 and p-W for the pairs that land on it (zero
// before the first pixel). Per axis d it runs the colour backward of
// the pair (bwd_axis, shared with pipeline_bwd.cu through aa_pair.cuh)
// and writes
//   rid2[d, p]  = the pair triangle's table row (b*T where it has none);
//   gval2[k, d*N + p] = the pair's 9 clip-space position-gradient
//          columns (pair_pos_grad on that row of vtbl: copysign(1e-3),
//          non-finite values zeroed), where the pair is kept (a real
//          triangle, dd != 0, |alpha| < 0.5), else 0;
// and, after both axes,
//   g_color = ((dy - v0) - v1) + v0[p-1] + v1[p-W], v = alpha * pdy the
//          pair blends, each neighbour's computed from its own alpha and
//          dy, so no second pass and no atomics.
// The TPU kernel's tile order, edge padding, any-hit guards and
// materialised shifted copies (_tile_order, _flatpad, _shifts) have no
// counterpart; gval2 keeps its dense [9, 2N] layout, and the reduction
// to triangle rows (scatter_rows.cu) keeps only its non-zero columns.
//
// Bound on the H100: device-memory traffic. Per pixel it reads
// (2C + 5) floats (the neighbour reads mostly from L1/L2) and writes
// C + 2 + 18 words, the dense gval2 being 18 of them; the vtbl row of a
// kept pair (a few per thousand pixels) stays in L2.
//
// Rounding: built with -fmad=false; every expression keeps the
// reference's operation order, so the plain twin (aa_backward_plain)
// agrees to the last bit.
#include <cuda_runtime.h>

#include "aa_pair.cuh"

namespace {

constexpr int BLOCK = 256;

template <int C, int D>
__device__ __forceinline__ void axis(int p, int q, int N, int T, int ro, float id0, float al,
                                     float ax, float fx, float fy, float pxh, float pyh,
                                     const float* __restrict__ idf,
                                     const float* __restrict__ ct,
                                     const float* __restrict__ dy,
                                     const float* __restrict__ vtbl, int cols, const float* dy0,
                                     const float* c0p, float* gc, int* __restrict__ rid2,
                                     float* __restrict__ gval2) {
    int rid;
    float kept;
    nvdr_aa::bwd_axis<C>(q, N, T, ro, id0, al, ax, idf, ct, dy, dy0, c0p, gc, rid, kept);
    rid2[static_cast<size_t>(D) * N + p] = rid;
    float g9[9];
    if (kept != 0.0f) {
        float t9[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) t9[k] = vtbl[static_cast<size_t>(k) * cols + rid];
        nvdr_aa::pair_pos_grad<D>(t9, kept, ax, fx, fy, pxh, pyh, g9);
    } else {
#pragma unroll
        for (int k = 0; k < 9; ++k) g9[k] = 0.0f;
    }
    const size_t n2 = 2 * static_cast<size_t>(N);
#pragma unroll
    for (int k = 0; k < 9; ++k) gval2[k * n2 + static_cast<size_t>(D) * N + p] = g9[k];
}

template <int C>
__global__ void __launch_bounds__(BLOCK)
aa_bwd_kernel(const float* __restrict__ dy, const float* __restrict__ ct,
              const float* __restrict__ idf, const float* __restrict__ vtbl, int cols,
              const float* __restrict__ al0, const float* __restrict__ ax0,
              const float* __restrict__ al1, const float* __restrict__ ax1,
              float* __restrict__ gcol, int* __restrict__ rid2, float* __restrict__ gval2, int N,
              int T, int RT, int H, int W, float fxo, float fyo, float pxh, float pyh) {
    const int p = blockIdx.x * BLOCK + threadIdx.x;
    if (p >= N) return;
    const int col = p % W;
    const int row = (p / W) % H;
    const int ro = (p / (H * W)) * RT;  // row offset b*T, 0 in range mode
    const float fx = static_cast<float>(col) + fxo;
    const float fy = static_cast<float>(row) + fyo;
    const float id0 = idf[p];

    float dy0[C], c0p[C], gc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        dy0[c] = dy[static_cast<size_t>(c) * N + p];
        c0p[c] = ct[static_cast<size_t>(c) * N + p];
        gc[c] = dy0[c];
    }

    // Both axes (borders fold onto the pixel itself).
    const int qx = (col >= W - 1) ? p : p + 1;
    const int qy = (row >= H - 1) ? p : p + W;
    axis<C, 0>(p, qx, N, T, ro, id0, al0[p], ax0[p], fx, fy, pxh, pyh, idf, ct, dy, vtbl, cols,
               dy0, c0p, gc, rid2, gval2);
    axis<C, 1>(p, qy, N, T, ro, id0, al1[p], ax1[p], fx, fy, pxh, pyh, idf, ct, dy, vtbl, cols,
               dy0, c0p, gc, rid2, gval2);

    // Blends the left (p-1) and upper (p-W) neighbours' pairs put here.
    const float a0m = p >= 1 ? al0[p - 1] : 0.0f;
    const float a1m = p >= W ? al1[p - W] : 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const float dm1 = p >= 1 ? dy[static_cast<size_t>(c) * N + p - 1] : 0.0f;
        const float dmW = p >= W ? dy[static_cast<size_t>(c) * N + p - W] : 0.0f;
        const float vm0 = a0m * (a0m > 0.0f ? dm1 : dy0[c]);
        const float vm1 = a1m * (a1m > 0.0f ? dmW : dy0[c]);
        gcol[static_cast<size_t>(c) * N + p] = gc[c] + vm0 + vm1;
    }
}

}  // namespace

// dy, ct [C, N]; idf, al0, ax0, al1, ax1 [N]; vtbl [9, cols]
// (cols = B*T + 1) -> g_color [C, N], rid2 [2, N] int32, gval2 [9, 2N]
// float32. 1 <= C <= 8.
extern "C" int nvdr_aa_bwd(const float* dy, const float* ct, const float* idf,
                           const float* vtbl, int cols, const float* al0, const float* ax0,
                           const float* al1, const float* ax1, float* gcol, int* rid2,
                           float* gval2, int N, int C, int T, int RT, int H, int W, float fxo,
                           float fyo, float pxh, float pyh, void* stream) {
    if (N <= 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int grid = (N + BLOCK - 1) / BLOCK;
#define NVDR_AA_BWD_CASE(n)                                                                   \
    case n:                                                                                   \
        aa_bwd_kernel<n><<<grid, BLOCK, 0, s>>>(dy, ct, idf, vtbl, cols, al0, ax0, al1, ax1,   \
                                                gcol, rid2, gval2, N, T, RT, H, W, fxo, fyo, pxh, \
                                                pyh);                                         \
        break;
    switch (C) {
        NVDR_AA_BWD_CASE(1)
        NVDR_AA_BWD_CASE(2)
        NVDR_AA_BWD_CASE(3)
        NVDR_AA_BWD_CASE(4)
        NVDR_AA_BWD_CASE(5)
        NVDR_AA_BWD_CASE(6)
        NVDR_AA_BWD_CASE(7)
        NVDR_AA_BWD_CASE(8)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef NVDR_AA_BWD_CASE
    return static_cast<int>(cudaGetLastError());
}
