// Fused interpolate(uv, diff_attrs) + rasterize(db) backward of the
// textured pipeline: per pixel, 15 slim gradient rows.
//
// Replaces: nvdiffrast_tpu/ops/pipeline_tex_pallas.py,
// interp_raster_bwd_tex.
//
// The TPU kernel gathers the uv table [6, R+1] and the clip-space vertex
// table [9, R+1] from VMEM with lane sweeps. Here both tables stay in
// device memory (238 KB at the bench scene's 3,968 triangles, L2
// resident) and each thread loads its pixel's triangle column. One thread
// per pixel:
//   - the interpolate backward: bary gradients gb0, gb1 from the masked
//     uv cotangents (gu, gv), the uv_da terms (c0_j, c1_j) = (d0 gdax_j +
//     d1 gday_j, d2 gdax_j + d3 gday_j) that grad_scatter expands with
//     the barycentric outer product, and the gradients to the bary
//     derivatives db;
//   - the rasterize backward with db: the 9 clip-space (x, y, w) vertex
//     gradients, with the copysign(1e-6) pole guard of the reference;
//   - writes out [15, N]: (gu, gv) masked, the 9 vertex columns (non-
//     finite values zeroed), then (c0_u, c0_v, c1_u, c1_v). Pixels
//     without a triangle write exact zeros.
//
// Bound on the H100: device-memory traffic: the id read and 15 floats
// written at every pixel, 10 more read (gu, gv, 4 gda, 4 db) at each
// covered one; about 200 float32 operations a covered pixel stay far
// below the compute bound.
//
// Rounding: built with -fmad=false; every expression is the reference's
// in its order, so the plain twin (interp_raster_bwd_tex_plain) agrees to
// the last bit.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK)
interp_raster_bwd_tex_kernel(const float* __restrict__ atbl, const float* __restrict__ vtbl,
                             int cols, const float* __restrict__ idf,
                             const float* __restrict__ gu, const float* __restrict__ gv,
                             const float* __restrict__ gda4, const float* __restrict__ db4,
                             float* __restrict__ out, int N, int T, int H, int W, float xs,
                             float xo, float ys, float yo, float xs_c, float ys_c) {
    const int p = blockIdx.x * BLOCK + threadIdx.x;
    if (p >= N) return;
    const size_t n = static_cast<size_t>(N);
    const int tid0 = static_cast<int>(idf[p]) - 1;
    if (!(tid0 >= 0 && tid0 < T)) {
#pragma unroll
        for (int k = 0; k < 15; ++k) out[k * n + p] = 0.0f;
        return;
    }
    const int r = tid0 + (p / (H * W)) * T;
    float a6[6], t9[9];
#pragma unroll
    for (int k = 0; k < 6; ++k) a6[k] = __ldg(atbl + static_cast<size_t>(k) * cols + r);
#pragma unroll
    for (int k = 0; k < 9; ++k) t9[k] = __ldg(vtbl + static_cast<size_t>(k) * cols + r);
    const float fxv = static_cast<float>(p % W) * xs + xo;
    const float fyv = static_cast<float>((p / W) % H) * ys + yo;

    // Interpolate backward.
    const float gyu = gu[p];
    const float gyv = gv[p];
    const float dsdu0 = a6[0] - a6[4];
    const float dsdu1 = a6[1] - a6[5];
    const float dsdv0 = a6[2] - a6[4];
    const float dsdv1 = a6[3] - a6[5];
    const float gb0 = gyu * dsdu0 + gyv * dsdu1;
    const float gb1 = gyu * dsdv0 + gyv * dsdv1;
    const float d0 = db4[p], d1 = db4[n + p], d2 = db4[2 * n + p], d3 = db4[3 * n + p];
    float dd0 = 0.0f, dd1 = 0.0f, dd2 = 0.0f, dd3 = 0.0f;
    float cda[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const float dsdu = j == 0 ? dsdu0 : dsdu1;
        const float dsdv = j == 0 ? dsdv0 : dsdv1;
        const float gdax = gda4[(2 * j) * n + p];
        const float gday = gda4[(2 * j + 1) * n + p];
        cda[2 * j] = d0 * gdax + d1 * gday;      // c0_j
        cda[2 * j + 1] = d2 * gdax + d3 * gday;  // c1_j
        dd0 = dd0 + gdax * dsdu;
        dd1 = dd1 + gday * dsdu;
        dd2 = dd2 + gdax * dsdv;
        dd3 = dd3 + gday * dsdv;
    }

    // Rasterize backward with bary derivatives.
    const float x0 = t9[0], y0 = t9[1], w0 = t9[2];
    const float x1 = t9[3], y1 = t9[4], w1 = t9[5];
    const float x2 = t9[6], y2 = t9[7], w2 = t9[8];
    const float p0x = x0 - fxv * w0;
    const float p0y = y0 - fyv * w0;
    const float p1x = x1 - fxv * w1;
    const float p1y = y1 - fyv * w1;
    const float p2x = x2 - fxv * w2;
    const float p2y = y2 - fyv * w2;
    const float a0 = p1x * p2y - p1y * p2x;
    const float a1 = p2x * p0y - p2y * p0x;
    const float a2 = p0x * p1y - p0y * p1x;
    const float at = a0 + a1 + a2;
    const float ep = at >= 0.0f ? 1e-6f : -1e-6f;
    const float iw = 1.0f / (at + ep);
    const float b0 = a0 * iw;
    const float b1 = a1 * iw;
    const float gB0 = gb0 * iw;
    const float gB1 = gb1 * iw;
    const float gbb = gB0 * b0 + gB1 * b1;
    float gp0x = gbb * (p2y - p1y) - gB1 * p2y;
    float gp1x = gbb * (p0y - p2y) + gB0 * p2y;
    float gp2x = gbb * (p1y - p0y) - gB0 * p1y + gB1 * p0y;
    float gp0y = gbb * (p1x - p2x) + gB1 * p2x;
    float gp1y = gbb * (p2x - p0x) - gB0 * p2x;
    float gp2y = gbb * (p0x - p1x) + gB0 * p1x - gB1 * p0x;
    float gp0w = -fxv * gp0x - fyv * gp0y;
    float gp1w = -fxv * gp1x - fyv * gp1y;
    float gp2w = -fxv * gp2x - fyv * gp2y;

    const float dfxdX = xs_c * iw;
    const float dfydY = ys_c * iw;
    dd0 = dd0 * dfxdX;
    dd1 = dd1 * dfydY;
    dd2 = dd2 * dfxdX;
    dd3 = dd3 * dfydY;
    const float da0dX = y1 * w2 - y2 * w1;
    const float da1dX = y2 * w0 - y0 * w2;
    const float da2dX = y0 * w1 - y1 * w0;
    const float da0dY = x2 * w1 - x1 * w2;
    const float da1dY = x0 * w2 - x2 * w0;
    const float da2dY = x1 * w0 - x0 * w1;
    const float datdX = da0dX + da1dX + da2dX;
    const float datdY = da0dY + da1dY + da2dY;
    const float x01 = x0 - x1, x12 = x1 - x2, x20 = x2 - x0;
    const float y01 = y0 - y1, y12 = y1 - y2, y20 = y2 - y0;
    const float w01 = w0 - w1, w12 = w1 - w2, w20 = w2 - w0;
    const float a0p1 = fyv * x2 - fxv * y2;
    const float a0p2 = fxv * y1 - fyv * x1;
    const float a1p0 = fxv * y2 - fyv * x2;
    const float a1p2 = fyv * x0 - fxv * y0;
    const float wdudX = 2.0f * b0 * datdX - da0dX;
    const float wdudY = 2.0f * b0 * datdY - da0dY;
    const float wdvdX = 2.0f * b1 * datdX - da1dX;
    const float wdvdY = 2.0f * b1 * datdY - da1dY;
    const float c0r = iw * (dd0 * wdudX + dd1 * wdudY + dd2 * wdvdX + dd3 * wdvdY);
    const float cx = c0r * fxv - dd0 * b0 - dd2 * b1;
    const float cy = c0r * fyv - dd1 * b0 - dd3 * b1;
    const float cxy = iw * (dd0 * datdX + dd1 * datdY);
    const float czw = iw * (dd2 * datdX + dd3 * datdY);
    gp0x = gp0x + c0r * y12 - cy * w12 + czw * p2y + dd3 * w2;
    gp1x = gp1x + c0r * y20 - cy * w20 - cxy * p2y - dd1 * w2;
    gp2x = gp2x + c0r * y01 - cy * w01 + cxy * p1y - czw * p0y + dd1 * w1 - dd3 * w0;
    gp0y = gp0y + cx * w12 - c0r * x12 - czw * p2x - dd2 * w2;
    gp1y = gp1y + cx * w20 - c0r * x20 + cxy * p2x + dd0 * w2;
    gp2y = gp2y + cx * w01 - c0r * x01 - cxy * p1x + czw * p0x - dd0 * w1 + dd2 * w0;
    gp0w = gp0w + cy * x12 - cx * y12 - czw * a1p0 + dd2 * y2 - dd3 * x2;
    gp1w = gp1w + cy * x20 - cx * y20 - cxy * a0p1 - dd0 * y2 + dd1 * x2;
    gp2w = gp2w + cy * x01 - cx * y01 - cxy * a0p2 - czw * a1p2 + dd0 * y1 - dd1 * x1 -
           dd2 * y0 + dd3 * x0;

    const float g9[9] = {gp0x, gp0y, gp0w, gp1x, gp1y, gp1w, gp2x, gp2y, gp2w};
    out[p] = gyu;
    out[n + p] = gyv;
#pragma unroll
    for (int k = 0; k < 9; ++k) out[(2 + k) * n + p] = isfinite(g9[k]) ? g9[k] : 0.0f;
    out[11 * n + p] = cda[0];  // c0_u
    out[12 * n + p] = cda[2];  // c0_v
    out[13 * n + p] = cda[1];  // c1_u
    out[14 * n + p] = cda[3];  // c1_v
}

}  // namespace

// atbl [6, cols], vtbl [9, cols] (cols = B*T + 1, zero column last); idf,
// gu, gv [N]; gda4, db4 [4, N] float32 -> out [15, N]. N = B*H*W; pixel
// centres at clip (p % W) * xs + xo, ((p / W) % H) * ys + yo; xs_c, ys_c
// the db image scales 2/W, 2/H.
extern "C" int nvdr_interp_raster_bwd_tex(const float* atbl, const float* vtbl, int cols,
                                          const float* idf, const float* gu, const float* gv,
                                          const float* gda4, const float* db4, float* out, int N,
                                          int T, int H, int W, float xs, float xo, float ys,
                                          float yo, float xs_c, float ys_c, void* stream) {
    if (N <= 0) return static_cast<int>(cudaGetLastError());
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    interp_raster_bwd_tex_kernel<<<(N + BLOCK - 1) / BLOCK, BLOCK, 0, s>>>(
        atbl, vtbl, cols, idf, gu, gv, gda4, db4, out, N, T, H, W, xs, xo, ys, yo, xs_c, ys_c);
    return static_cast<int>(cudaGetLastError());
}
