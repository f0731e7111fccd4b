// Gradient scatter of the render pipeline: per-pixel rows -> per-triangle
// rows, deterministic.
//
// Replaces: nvdiffrast_tpu/ops/pipeline_pallas.py, pipeline_grad_scatter,
// with and without the textured chain's da4 terms.
//
// The TPU kernel is a windowed one-hot bf16 hi/lo matmul on the MXU,
// with a sequential grid carrying the accumulator. On this card blocks
// run in no order and float atomics would make the gradients change
// from run to run, so the reduction is by segment instead. The wrapper
// (pipeline_bwd_cuda._entries, index glue) lists the live entries:
//   type 0, pixel p: the own-pixel row of a pixel with a non-zero gs
//     (or da4) column, keyed by its triangle row rid0[p];
//   type 1 + d, pixel p: the AA pair of axis d where dd2[d, p] != 0,
//     keyed by rid2[d, p];
// as codes type*N + p, stable-sorted by key, with each row's segment
// [off[r], off[r+1]). One warp owns one table row r. Its lanes walk the
// segment (lane l takes entries l, l+32, ...), expand each entry in
// registers and sum in float64:
//   type 0: the bary outer product bb_k * gc_a (k = 0..2) into columns
//     k*A + a of gt, and the 9 raster columns of gs into 3A..3A+8; with
//     da4 (the textured chain, A = 2) its uv_da terms (c0_j, c1_j) ride
//     along: bb0*g_j + c0_j, bb1*g_j + c1_j, (bb2*g_j - c0_j) - c1_j,
//     each in float32 as the reference, then summed in float64;
//   type 1/2: pair_pos_grad replayed from row r of vtbl (one load per
//     warp, the TPU kernel's one-hot gather) and fx/fy recomputed from p,
//     into the 9 columns of gaa.
// A butterfly of warp shuffles adds the 32 partial sums in a fixed
// order; each sum is rounded to float32 once. Same inputs, same bits.
//
// Bound on the H100: device-memory traffic of the live entries (their
// code, gs column or dd/aux, bary) plus the [R, 3A+18] outputs; the
// segment walk is gather-bound. The float64 adds are 3A+9 or 9 per
// entry, far below the card's float64 rate.
#include <cuda_runtime.h>

#include "aa_pair.cuh"
#include "segment_sum.cuh"

namespace {

using nvdr_aa::pair_pos_grad;
using nvdr_seg::warp_sum;

constexpr int WARPS = 4;  // table rows per block
constexpr int BLOCK = 32 * WARPS;

template <int A, bool DA>
__global__ void __launch_bounds__(BLOCK)
grad_scatter_kernel(const int* __restrict__ off, const int* __restrict__ codes,
                    const float* __restrict__ gs, const float* __restrict__ dd2,
                    const float* __restrict__ b0, const float* __restrict__ b1,
                    const float* __restrict__ ax0, const float* __restrict__ ax1,
                    const float* __restrict__ da4, const float* __restrict__ vtbl, int cols,
                    float* __restrict__ gt,
                    float* __restrict__ gaa, int N, int R, int H, int W, float fxo, float fyo,
                    float pxh, float pyh) {
    constexpr int K = 3 * A + 9;
    const int r = blockIdx.x * WARPS + threadIdx.x / 32;  // uniform over the warp
    const int lane = threadIdx.x % 32;
    if (r >= R) return;

    float t9[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) t9[k] = vtbl[static_cast<size_t>(k) * cols + r];
    double acc[K], aa[9];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.0;
#pragma unroll
    for (int k = 0; k < 9; ++k) aa[k] = 0.0;

    const int e1 = off[r + 1];
    for (int e = off[r] + lane; e < e1; e += 32) {
        const int code = codes[e];
        const int type = code / N;
        const int p = code - type * N;
        if (type == 0) {
            const float bb0 = b0[p];
            const float bb1 = b1[p];
            const float bb2 = 1.0f - bb0 - bb1;
#pragma unroll
            for (int a = 0; a < A; ++a) {
                const float g = gs[static_cast<size_t>(a) * N + p];
                if (DA) {  // A == 2: c0_a = da4[a], c1_a = da4[2 + a]
                    const float c0 = da4[static_cast<size_t>(a) * N + p];
                    const float c1 = da4[static_cast<size_t>(2 + a) * N + p];
                    acc[a] += static_cast<double>(bb0 * g + c0);
                    acc[A + a] += static_cast<double>(bb1 * g + c1);
                    acc[2 * A + a] += static_cast<double>(bb2 * g - c0 - c1);
                } else {
                    acc[a] += static_cast<double>(bb0 * g);
                    acc[A + a] += static_cast<double>(bb1 * g);
                    acc[2 * A + a] += static_cast<double>(bb2 * g);
                }
            }
#pragma unroll
            for (int k = 0; k < 9; ++k)
                acc[3 * A + k] += static_cast<double>(gs[static_cast<size_t>(A + k) * N + p]);
        } else {
            const float fx = static_cast<float>(p % W) + fxo;
            const float fy = static_cast<float>((p / W) % H) + fyo;
            float g9[9];
            if (type == 1)
                pair_pos_grad<0>(t9, dd2[p], ax0[p], fx, fy, pxh, pyh, g9);
            else
                pair_pos_grad<1>(t9, dd2[static_cast<size_t>(N) + p], ax1[p], fx, fy, pxh, pyh,
                                 g9);
#pragma unroll
            for (int k = 0; k < 9; ++k) aa[k] += static_cast<double>(g9[k]);
        }
    }

#pragma unroll
    for (int k = 0; k < K; ++k) {
        const double s = warp_sum(acc[k]);
        if (lane == 0) gt[static_cast<size_t>(r) * K + k] = static_cast<float>(s);
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) {
        const double s = warp_sum(aa[k]);
        if (lane == 0) gaa[static_cast<size_t>(r) * 9 + k] = static_cast<float>(s);
    }
}

}  // namespace

// off [R+1], codes [M] int32 (sorted live entries, type*N + p); gs
// [A+9, N], dd2 [2, N], b0, b1, ax0, ax1 [N], da4 [4, N] or null, vtbl
// [9, cols] float32 -> gt [R, 3A+9], gaa [R, 9] float32. 1 <= A <= 8;
// A == 2 with da4.
extern "C" int nvdr_grad_scatter(const int* off, const int* codes, const float* gs,
                                 const float* dd2, const float* b0, const float* b1,
                                 const float* ax0, const float* ax1, const float* da4,
                                 const float* vtbl, int cols,
                                 float* gt, float* gaa, int N, int R, int A, int H, int W,
                                 float fxo, float fyo, float pxh, float pyh, void* stream) {
    if (R <= 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int grid = (R + WARPS - 1) / WARPS;
    if (da4 != nullptr) {
        if (A != 2) return static_cast<int>(cudaErrorInvalidValue);
        grad_scatter_kernel<2, true><<<grid, BLOCK, 0, s>>>(off, codes, gs, dd2, b0, b1, ax0,
                                                            ax1, da4, vtbl, cols, gt, gaa, N, R,
                                                            H, W, fxo, fyo, pxh, pyh);
        return static_cast<int>(cudaGetLastError());
    }
#define NVDR_SCATTER_CASE(n)                                                                 \
    case n:                                                                                  \
        grad_scatter_kernel<n, false><<<grid, BLOCK, 0, s>>>(off, codes, gs, dd2, b0, b1,    \
                                                             ax0, ax1, da4, vtbl, cols, gt,  \
                                                             gaa, N, R, H, W, fxo, fyo, pxh, \
                                                             pyh);                           \
        break;
    switch (A) {
        NVDR_SCATTER_CASE(1)
        NVDR_SCATTER_CASE(2)
        NVDR_SCATTER_CASE(3)
        NVDR_SCATTER_CASE(4)
        NVDR_SCATTER_CASE(5)
        NVDR_SCATTER_CASE(6)
        NVDR_SCATTER_CASE(7)
        NVDR_SCATTER_CASE(8)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef NVDR_SCATTER_CASE
    return static_cast<int>(cudaGetLastError());
}
