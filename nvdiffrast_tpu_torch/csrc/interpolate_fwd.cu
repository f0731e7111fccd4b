// Interpolate forward: attribute gather, bary combine and the screen
// derivatives of the attributes from the rasterizer's bary derivatives.
//
// Replaces: nvdiffrast_tpu/ops/interpolate_pallas.py, interp_forward_fused,
// together with the masking glue in front of it (pipeline_tex.py:84-93,
// interpolate._flat_ids, _pixel_ids): one table for all images
// (broadcast attributes) or one per image.
//
// One thread per pixel. Each thread reads its (u, v, idf) and, with
// derivatives, the four db flats (dudx, dudy, dvdx, dvdy); decodes the
// triangle id (coord.float_to_triidx); masks invalid pixels to zero
// barys and zero db; gathers its triangle's column of the attribute table
// [3A, rows+1] (row k*A + a = channel a of vertex k; per-image tables
// take row b*T + t, broadcast ones row t) with plain global loads (the
// table stays in L1/L2); and writes
//   out[a]      = (b0*g[a] + b1*g[A+a]) + b2*g[2A+a],   b2 = (1 - u) - v;
//   da[2j]      = dudx*dsdu + dvdx*dsdv,  da[2j+1] = dudy*dsdu + dvdy*dsdv
// for the j-th differentiated attribute d (dsdu = g[d] - g[2A+d],
// dsdv = g[A+d] - g[2A+d]). Outputs are channel-major [A, N] and [2D, N].
// The TPU kernel's lane-gather sweep (_gather_rows) is a VMEM workaround
// with no counterpart here.
//
// Bound on the H100: device-memory traffic, (3 + 4) flats read and
// (A + 2D) written per pixel; 15 words at A = D = 2. The operations
// (about 4A + 6D per pixel) are far below the float32 peak.
//
// Rounding: built with -fmad=false; every expression keeps the
// reference's operation order, so the plain twin (interp_forward_plain)
// agrees to the last bit.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BLOCK = 256;

// coord.float_to_triidx: ids up to 2^24 are plain floats, larger ones
// are biased bit patterns.
__device__ __forceinline__ int float_to_triidx(float x) {
    return x <= 16777216.0f ? static_cast<int>(x) : __float_as_int(x) - 0x4A800000;
}

template <int A>
__global__ void __launch_bounds__(BLOCK)
interp_fwd_kernel(const float* __restrict__ tbl, int cols, const float* __restrict__ u,
                  const float* __restrict__ v, const float* __restrict__ idf,
                  const float* __restrict__ dux, const float* __restrict__ duy,
                  const float* __restrict__ dvx, const float* __restrict__ dvy,
                  float* __restrict__ out, float* __restrict__ da, int N, int T, int HW,
                  int D, unsigned long long diff) {
    const int p = blockIdx.x * BLOCK + threadIdx.x;
    if (p >= N) return;
    const int tid = float_to_triidx(idf[p]) - 1;
    const bool valid = (tid >= 0) && (tid < T);
    const int row = tid + (HW > 0 ? (p / HW) * T : 0);

    float g[3 * A];
#pragma unroll
    for (int k = 0; k < 3 * A; ++k)
        g[k] = valid ? tbl[static_cast<size_t>(k) * cols + row] : 0.0f;
    const float up = u[p], vp = v[p];
    const float b0 = valid ? up : 0.0f;
    const float b1 = valid ? vp : 0.0f;
    const float b2 = valid ? (1.0f - up) - vp : 0.0f;
#pragma unroll
    for (int a = 0; a < A; ++a)
        out[static_cast<size_t>(a) * N + p] = (b0 * g[a] + b1 * g[A + a]) + b2 * g[2 * A + a];

    if (D == 0) return;
    const float ux = valid ? dux[p] : 0.0f;
    const float uy = valid ? duy[p] : 0.0f;
    const float vx = valid ? dvx[p] : 0.0f;
    const float vy = valid ? dvy[p] : 0.0f;
#pragma unroll
    for (int d = 0; d < A; ++d) {
        // Differentiated attributes, in the caller's order: 4 bits each.
        if (d >= D) break;
        const int j = static_cast<int>((diff >> (4 * d)) & 15u);
        float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
#pragma unroll
        for (int a = 0; a < A; ++a) {
            if (a == j) {
                g0 = g[a];
                g1 = g[A + a];
                g2 = g[2 * A + a];
            }
        }
        const float dsdu = g0 - g2;
        const float dsdv = g1 - g2;
        da[static_cast<size_t>(2 * d) * N + p] = ux * dsdu + vx * dsdv;
        da[static_cast<size_t>(2 * d + 1) * N + p] = uy * dsdu + vy * dsdv;
    }
}

}  // namespace

// tbl [3A, cols] (cols = rows + 1, dummy zero column last); u, v, idf
// [N]; db flats [N] (unused when D = 0); out [A, N]; da [2D, N].
// HW = H*W for per-image tables (row b*T + t), 0 for one table.
// 1 <= A <= 16, 0 <= D <= A; diff holds the D attribute indices, 4 bits
// each, the first in the lowest bits.
extern "C" int nvdr_interp_fwd(const float* tbl, int cols, const float* u, const float* v,
                               const float* idf, const float* dux, const float* duy,
                               const float* dvx, const float* dvy, float* out, float* da, int N,
                               int A, int T, int HW, int D, unsigned long long diff,
                               void* stream) {
    if (N <= 0) return static_cast<int>(cudaGetLastError());
    if (D < 0 || D > A || HW < 0) return static_cast<int>(cudaErrorInvalidValue);
    const int grid = (N + BLOCK - 1) / BLOCK;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NVDR_INTERP_CASE(n)                                                                  \
    case n:                                                                                  \
        interp_fwd_kernel<n><<<grid, BLOCK, 0, s>>>(tbl, cols, u, v, idf, dux, duy, dvx, dvy, \
                                                    out, da, N, T, HW, D, diff);             \
        break;
    switch (A) {
        NVDR_INTERP_CASE(1)
        NVDR_INTERP_CASE(2)
        NVDR_INTERP_CASE(3)
        NVDR_INTERP_CASE(4)
        NVDR_INTERP_CASE(5)
        NVDR_INTERP_CASE(6)
        NVDR_INTERP_CASE(7)
        NVDR_INTERP_CASE(8)
        NVDR_INTERP_CASE(9)
        NVDR_INTERP_CASE(10)
        NVDR_INTERP_CASE(11)
        NVDR_INTERP_CASE(12)
        NVDR_INTERP_CASE(13)
        NVDR_INTERP_CASE(14)
        NVDR_INTERP_CASE(15)
        NVDR_INTERP_CASE(16)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef NVDR_INTERP_CASE
    return static_cast<int>(cudaGetLastError());
}
