// Interpolate backward: the gradients to the barycentrics, to the
// attributes (per pixel, before the reduction to triangle rows) and to
// the rasterizer's bary derivatives.
//
// Replaces: nvdiffrast_tpu/ops/interpolate_pallas.py, interp_backward_fused
// (interpolate.py:146-193 in the XLA path).
//
// One thread per pixel. Each thread decodes its triangle id
// (coord.float_to_triidx), masks invalid pixels to zero barycentrics
// and zero db, gathers its triangle's column of the attribute table
// [3A, rows+1] again (row k*A + a = channel a of vertex k; per-image
// tables take row b*T + t, broadcast ones row t) with plain global
// loads, and writes
//   grast[0] = gb0 + sum_a gy[a] * (g[a] - g[2A+a]),
//   grast[1] = gb1 + sum_a gy[a] * (g[A+a] - g[2A+a]),
//   gval[k*A + a] = bk * gy[a] (b2 = (1 - u) - v), and for each
//     differentiated attribute j with cotangents (gdax, gday):
//     c0 = dudx*gdax + dudy*gday, c1 = dvdx*gdax + dvdy*gday added to
//     rows j, A+j and subtracted from 2A+j,
//   gdb[0..3] = gdb + the (gdax, gday) x (dsdu, dsdv) products,
// gval and gdb zero where the pixel has no triangle. gb0, gb1 and gdb
// start at 0, or, with `accumulate`, at what grast and gdb hold: the
// wrapper runs attributes past 16 as further chunks of 16 through the
// same kernel, and the sums then go on in the reference's order.
// The TPU kernel's lane-gather sweep (_gather_rows) is a VMEM workaround
// with no counterpart here.
//
// Bound on the H100: device-memory traffic. Per pixel it reads
// (3 + A) floats, 4 + 2D more with D differentiated attributes, and
// writes (2 + 3A) floats, 4 more with D > 0; 17 words at A = 3, D = 0.
//
// Rounding: built with -fmad=false; every expression keeps the
// reference's operation order, so the plain twin (interp_backward_plain)
// agrees to the last bit.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

__device__ __forceinline__ int float_to_triidx(float x) {
    return x <= 16777216.0f ? static_cast<int>(x) : __float_as_int(x) - 0x4A800000;
}

template <int A>
__global__ void __launch_bounds__(BLOCK)
interp_bwd_kernel(const float* __restrict__ tbl, int cols, const float* __restrict__ u,
                  const float* __restrict__ v, const float* __restrict__ idf,
                  const float* __restrict__ dux, const float* __restrict__ duy,
                  const float* __restrict__ dvx, const float* __restrict__ dvy,
                  const float* __restrict__ gy, const float* __restrict__ gda,
                  float* __restrict__ grast, float* __restrict__ gval, float* __restrict__ gdb,
                  int N, int T, int HW, int D, unsigned long long diff, int accumulate) {
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

    float gya[A];
    float gb0 = accumulate ? grast[p] : 0.0f;
    float gb1 = accumulate ? grast[static_cast<size_t>(N) + p] : 0.0f;
    float ga[3 * A];
#pragma unroll
    for (int a = 0; a < A; ++a) {
        gya[a] = gy[static_cast<size_t>(a) * N + p];
        gb0 = gb0 + gya[a] * (g[a] - g[2 * A + a]);
        gb1 = gb1 + gya[a] * (g[A + a] - g[2 * A + a]);
        ga[a] = b0 * gya[a];
        ga[A + a] = b1 * gya[a];
        ga[2 * A + a] = b2 * gya[a];
    }
    grast[p] = gb0;
    grast[static_cast<size_t>(N) + p] = gb1;

    if (D > 0) {
        const float ux = valid ? dux[p] : 0.0f;
        const float uy = valid ? duy[p] : 0.0f;
        const float vx = valid ? dvx[p] : 0.0f;
        const float vy = valid ? dvy[p] : 0.0f;
        float gd[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
            gd[c] = accumulate ? gdb[static_cast<size_t>(c) * N + p] : 0.0f;
        for (int d = 0; d < D; ++d) {
            // Differentiated attributes, in the caller's order: 4 bits each.
            const int j = static_cast<int>((diff >> (4 * d)) & 15u);
            const float gdax = gda[static_cast<size_t>(2 * d) * N + p];
            const float gday = gda[static_cast<size_t>(2 * d + 1) * N + p];
            const float c0 = ux * gdax + uy * gday;
            const float c1 = vx * gdax + vy * gday;
            float dsdu = 0.0f, dsdv = 0.0f;
#pragma unroll
            for (int a = 0; a < A; ++a) {
                if (a == j) {
                    ga[a] = ga[a] + c0;
                    ga[A + a] = ga[A + a] + c1;
                    ga[2 * A + a] = ga[2 * A + a] - c0 - c1;
                    dsdu = g[a] - g[2 * A + a];
                    dsdv = g[A + a] - g[2 * A + a];
                }
            }
            gd[0] = gd[0] + gdax * dsdu;
            gd[1] = gd[1] + gday * dsdu;
            gd[2] = gd[2] + gdax * dsdv;
            gd[3] = gd[3] + gday * dsdv;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) gdb[static_cast<size_t>(c) * N + p] = valid ? gd[c] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 3 * A; ++k) gval[static_cast<size_t>(k) * N + p] = valid ? ga[k] : 0.0f;
}

}  // namespace

// tbl [3A, cols] (cols = rows + 1, dummy zero column last); u, v, idf,
// db flats [N] (db unused when D = 0); gy [A, N]; gda [2D, N] ->
// grast [2, N], gval [3A, N], gdb [4, N] (unused when D = 0).
// HW = H*W for per-image tables (row b*T + t), 0 for one table.
// 1 <= A <= 16, 0 <= D <= 16; diff holds the D attribute indices,
// 4 bits each, the first in the lowest bits. accumulate != 0 adds to
// what grast and gdb hold.
extern "C" int nvdr_interp_bwd(const float* tbl, int cols, const float* u, const float* v,
                               const float* idf, const float* dux, const float* duy,
                               const float* dvx, const float* dvy, const float* gy,
                               const float* gda, float* grast, float* gval, float* gdb, int N,
                               int A, int T, int HW, int D, unsigned long long diff,
                               int accumulate, void* stream) {
    if (N <= 0) return static_cast<int>(cudaGetLastError());
    if (D < 0 || D > 16 || HW < 0) return static_cast<int>(cudaErrorInvalidValue);
    const int grid = (N + BLOCK - 1) / BLOCK;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NVDR_INTERP_BWD_CASE(n)                                                              \
    case n:                                                                                  \
        interp_bwd_kernel<n><<<grid, BLOCK, 0, s>>>(tbl, cols, u, v, idf, dux, duy, dvx, dvy, \
                                                    gy, gda, grast, gval, gdb, N, T, HW, D,  \
                                                    diff, accumulate);                       \
        break;
    switch (A) {
        NVDR_INTERP_BWD_CASE(1)
        NVDR_INTERP_BWD_CASE(2)
        NVDR_INTERP_BWD_CASE(3)
        NVDR_INTERP_BWD_CASE(4)
        NVDR_INTERP_BWD_CASE(5)
        NVDR_INTERP_BWD_CASE(6)
        NVDR_INTERP_BWD_CASE(7)
        NVDR_INTERP_BWD_CASE(8)
        NVDR_INTERP_BWD_CASE(9)
        NVDR_INTERP_BWD_CASE(10)
        NVDR_INTERP_BWD_CASE(11)
        NVDR_INTERP_BWD_CASE(12)
        NVDR_INTERP_BWD_CASE(13)
        NVDR_INTERP_BWD_CASE(14)
        NVDR_INTERP_BWD_CASE(15)
        NVDR_INTERP_BWD_CASE(16)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef NVDR_INTERP_BWD_CASE
    return static_cast<int>(cudaGetLastError());
}
