// Antialias forward of a colour image on flat channel-major buffers.
//
// Replaces: nvdiffrast_tpu/ops/antialias_pallas.py, aa_forward_fused_cols
// (instance and range mode, viewport bands). Table rows: pixel of image
// b, triangle t -> b*RT + t (RT = T in instance mode, 0 in range mode).
// Viewport: fyo = y0 + 0.5 - 0.5*Hf puts the band's rows on the full
// image; the band's top and bottom rows fold as borders.
//
// One thread per pixel. Each thread reads its own and its right and down
// neighbours' (id, z/w, colour[C]) straight from the flat buffers (borders
// fold onto the pixel itself, which disables the pair), and for each axis
// picks the pair's triangle (pair_ids), gathers its row of the AA forward
// table [7, B*T+1] with plain global loads (the table stays in L1/L2),
// runs the edge crossing analysis (pair_alpha, shared with shade_fwd.cu
// through aa_pair.cuh) and writes
//   out  = colour plus the pair contributions alpha*(c1 - c0) with
//          alpha > 0 (they land on this pixel);
//   negx/negy = the contributions with alpha <= 0, which land on the
//          right/down neighbour (added by the caller, finish_shade, in
//          the reference's order, without atomics);
//   al0, ax0, al1, ax1 = the per-axis alpha and (edge + 4*is_t1), the
//          residuals a backward consumes where alpha != 0,
// all row-major. The TPU kernel's tile order (_tile_order) and masked
// lane-gather sweep were VMEM workarounds and are not carried over.
//
// Bound on the H100: device-memory traffic, 3x(2 + C) floats read and
// (3C + 4) written per pixel (18 and 13 words at C = 3, the neighbour
// reads mostly from L1/L2).
//
// Rounding: built with -fmad=false; every expression keeps the
// reference's operation order, so the plain twin (aa_forward_plain)
// agrees to the last bit.
#include <cuda_runtime.h>

#include "aa_pair.cuh"

namespace {

using nvdr_aa::pair_alpha;
using nvdr_aa::pair_ids;

constexpr int BLOCK = 256;

template <int C, int D>
__device__ __forceinline__ void axis(const float* __restrict__ ct,
                                     const float* __restrict__ ftbl, int cols,
                                     const float* __restrict__ zw,
                                     const float* __restrict__ idf, int p, int q, int N, int T,
                                     int ro, float id0, float z0, float fx, float fy,
                                     const float* c0, float* out, float* __restrict__ neg,
                                     float* __restrict__ al, float* __restrict__ ax) {
    int tsel;
    bool is_t1, active;
    pair_ids(id0, idf[q], z0, zw[q], T, tsel, is_t1, active);
    float t7[7];
#pragma unroll
    for (int k = 0; k < 7; ++k)
        t7[k] = active ? ftbl[static_cast<size_t>(k) * cols + tsel + ro] : 0.0f;
    float alpha;
    int di;
    pair_alpha<D>(t7, fx, fy, is_t1, active, alpha, di);
    const bool apos = alpha > 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const float contrib = alpha * (ct[static_cast<size_t>(c) * N + q] - c0[c]);
        out[c] = out[c] + (apos ? contrib : 0.0f);
        neg[static_cast<size_t>(c) * N + p] = apos ? 0.0f : contrib;
    }
    al[p] = alpha;
    ax[p] = static_cast<float>(di) + 4.0f * (is_t1 ? 1.0f : 0.0f);
}

template <int C>
__global__ void __launch_bounds__(BLOCK)
aa_fwd_kernel(const float* __restrict__ ct, const float* __restrict__ idf,
              const float* __restrict__ zw, const float* __restrict__ ftbl, int cols,
              float* __restrict__ out_own, float* __restrict__ negx, float* __restrict__ negy,
              float* __restrict__ al0, float* __restrict__ ax0, float* __restrict__ al1,
              float* __restrict__ ax1, int N, int T, int RT, int H, int W, float fxo, float fyo) {
    const int p = blockIdx.x * BLOCK + threadIdx.x;
    if (p >= N) return;
    const int col = p % W;
    const int row = (p / W) % H;
    const int ro = (p / (H * W)) * RT;  // row offset b*T, 0 in range mode
    const float fx = static_cast<float>(col) + fxo;
    const float fy = static_cast<float>(row) + fyo;
    const float id0 = idf[p];
    const float z0 = zw[p];
    float c0[C], out[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
        c0[c] = ct[static_cast<size_t>(c) * N + p];
        out[c] = c0[c];
    }
    // Both axes (borders fold onto the pixel itself).
    const int qx = (col >= W - 1) ? p : p + 1;
    const int qy = (row >= H - 1) ? p : p + W;
    axis<C, 0>(ct, ftbl, cols, zw, idf, p, qx, N, T, ro, id0, z0, fx, fy, c0, out, negx, al0,
               ax0);
    axis<C, 1>(ct, ftbl, cols, zw, idf, p, qy, N, T, ro, id0, z0, fx, fy, c0, out, negy, al1,
               ax1);
#pragma unroll
    for (int c = 0; c < C; ++c) out_own[static_cast<size_t>(c) * N + p] = out[c];
}

}  // namespace

// ct [C, N] colour; idf, zw [N]; ftbl [7, cols] (cols = B*T + 1);
// out, negx, negy [C, N]; al0, ax0, al1, ax1 [N]. 1 <= C <= 8.
extern "C" int nvdr_aa_fwd(const float* ct, const float* idf, const float* zw,
                           const float* ftbl, int cols, float* out, float* negx, float* negy,
                           float* al0, float* ax0, float* al1, float* ax1, int N, int C, int T,
                           int RT, int H, int W, float fxo, float fyo, void* stream) {
    if (N <= 0) return static_cast<int>(cudaGetLastError());
    const int grid = (N + BLOCK - 1) / BLOCK;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NVDR_AA_CASE(n)                                                                     \
    case n:                                                                                 \
        aa_fwd_kernel<n><<<grid, BLOCK, 0, s>>>(ct, idf, zw, ftbl, cols, out, negx, negy,  \
                                                al0, ax0, al1, ax1, N, T, RT, H, W, fxo, fyo); \
        break;
    switch (C) {
        NVDR_AA_CASE(1)
        NVDR_AA_CASE(2)
        NVDR_AA_CASE(3)
        NVDR_AA_CASE(4)
        NVDR_AA_CASE(5)
        NVDR_AA_CASE(6)
        NVDR_AA_CASE(7)
        NVDR_AA_CASE(8)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef NVDR_AA_CASE
    return static_cast<int>(cudaGetLastError());
}
