// Rasterizer: coverage, depth test and shading to (u, v, z/w, id) in one
// pass over per-triangle records.
//
// Replaces: nvdiffrast_tpu/ops/rasterize_pallas.py, rasterize_fused with
// its kernel body _make_kernel (instance mode, flat), without and with
// emit_db: the db variant also keeps the winner's six edge gradients
// (cx0, cy0, cx1, cy1, cx2, cy2) in registers and writes the four bary
// pixel derivatives (dudx, dudy, dvdx, dvdy) in the final step.
//
// Input per image b: records [T, 16] f32 built by the prepass in
// ops/rasterize_cuda.py (3 winding-normalized affine edge functions
// (c, d/dfx, d/dfy), the z plane, the w plane, id+1 or 1e30 when
// invalid) and their screen AABBs [T, 4] (xmin, ymin, xmax, ymax in
// pixel-index units, coverage slop included; empty = (+1e30, -1e30)).
//
// Design: one block per 16x16 pixel tile, one thread per pixel. The
// block streams the records through shared memory 256 at a time; each
// thread tests one record's AABB against the tile and a warp-ballot
// compaction keeps the hits in id order, so every pixel merges its
// candidates in ascending id order. The running (pz, pw, id, a0, a1,
// a2) state lives in registers; u, v, z/w and id are written once.
// The TPU kernel's sort binning, chunk remap and CSR layout were its
// answer to VMEM/SMEM limits and are not carried over.
//
// Bound on the H100: instruction throughput of the per-record AABB
// tests and per-pixel edge evaluations (T * tiles tests; ~1e3 flops per
// covered pixel per candidate); device-memory traffic is only the record
// stream (L2 resident) and one write of 4 floats per pixel. Later work:
// bin the records per tile first so a tile walks only its own hits.
//
// Rounding: built with -fmad=false, and the lines where coverage
// depends on the last bit use __fmul_rn/__fadd_rn explicitly, in the
// operation order of the reference, so the plain PyTorch twin
// (rasterize_records_plain) reproduces this kernel bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;            // tile edge in pixels (RASTER_TILE)
constexpr int NT = TILE * TILE;     // threads per block = records per batch
constexpr int REC = 16;             // floats per record
constexpr int SREC = 19;            // record + near-clip cut line (3)
constexpr float BIG = 1e30f;
constexpr float ID_INVALID = 1e30f;
constexpr float ID_VALID_THRESH = 1e29f;
constexpr float CLIP_EPS = 1e-9f;

// jnp.clip / jnp.maximum semantics: a NaN operand propagates.
__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
    return x != x ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float max_nan(float x, float y) {
    return x != x ? x : fmaxf(x, y);
}

// (s0 + s1*fx) + s2*fy, each operation rounded on its own.
__device__ __forceinline__ float affine(const float* s, float fx, float fy) {
    return __fadd_rn(__fadd_rn(s[0], __fmul_rn(s[1], fx)), __fmul_rn(s[2], fy));
}

// Exclusive on-edge tie rule: a pixel exactly on an edge belongs to the
// side whose edge gradient points +y, or +x when it is horizontal.
__device__ __forceinline__ bool tie(const float* s) {
    return (s[2] > 0.0f) || ((s[2] == 0.0f) && (s[1] > 0.0f));
}

__device__ __forceinline__ bool inside_edge(float a, const float* s) {
    return (a > 0.0f) || ((a == 0.0f) && tie(s));
}

template <bool DB>
__global__ void __launch_bounds__(NT)
raster_kernel(const float* __restrict__ rec, const float4* __restrict__ aabb,
              float* __restrict__ u_out, float* __restrict__ v_out,
              float* __restrict__ zw_out, float* __restrict__ idf_out,
              float* __restrict__ dudx_out, float* __restrict__ dudy_out,
              float* __restrict__ dvdx_out, float* __restrict__ dvdy_out,
              int T, int H, int W, float xs, float xo, float ys, float yo) {
    __shared__ float s_rec[NT][SREC];
    __shared__ int s_count[NT / 32];

    const int b = blockIdx.z;
    const int tx0 = blockIdx.x * TILE;
    const int ty0 = blockIdx.y * TILE;
    const int px = tx0 + (threadIdx.x % TILE);
    const int py = ty0 + (threadIdx.x / TILE);
    const bool in_image = (px < W) && (py < H);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;

    // Pixel center in clip space, (p * s) + o.
    const float fx = __fadd_rn(__fmul_rn(static_cast<float>(px), xs), xo);
    const float fy = __fadd_rn(__fmul_rn(static_cast<float>(py), ys), yo);
    const float ftx0 = static_cast<float>(tx0);
    const float ftx1 = static_cast<float>(tx0 + TILE - 1);
    const float fty0 = static_cast<float>(ty0);
    const float fty1 = static_cast<float>(ty0 + TILE - 1);

    // Running lexicographic (z/w, id) minimum and the winner's edges.
    float az = BIG, aw = 1.0f, aid = ID_INVALID;
    float pa0 = 0.0f, pa1 = 0.0f, pa2 = 0.0f;
    // Winner's edge gradients (d/dfx, d/dfy of each edge), DB only.
    float cx0 = 0.0f, cy0 = 0.0f, cx1 = 0.0f, cy1 = 0.0f, cx2 = 0.0f, cy2 = 0.0f;

    const float* rec_b = rec + static_cast<size_t>(b) * T * REC;
    const float4* aabb_b = aabb + static_cast<size_t>(b) * T;

    for (int base = 0; base < T; base += NT) {
        const int i = base + threadIdx.x;
        bool hit = false;
        if (i < T) {
            const float4 bb = aabb_b[i];
            hit = (bb.y <= fty1) && (bb.w >= fty0) && (bb.x <= ftx1) && (bb.z >= ftx0);
        }
        // Compact the hits into s_rec in thread (= id) order.
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (lane == 0) s_count[warp] = __popc(m);
        __syncthreads();
        int off = 0, n = 0;
#pragma unroll
        for (int w = 0; w < NT / 32; ++w) {
            const int c = s_count[w];
            off += (w < warp) ? c : 0;
            n += c;
        }
        if (hit) {
            float* dst = s_rec[off + __popc(m & ((1u << lane) - 1u))];
            const float4* src = reinterpret_cast<const float4*>(rec_b + static_cast<size_t>(i) * REC);
            float s[REC];
#pragma unroll
            for (int q = 0; q < REC / 4; ++q) {
                const float4 f = src[q];
                s[4 * q + 0] = f.x;
                s[4 * q + 1] = f.y;
                s[4 * q + 2] = f.z;
                s[4 * q + 3] = f.w;
            }
#pragma unroll
            for (int q = 0; q < REC; ++q) dst[q] = s[q];
            // Near-clip cut line pw - eps*(a0 + a1 + a2), as affine coefficients.
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                const float sum = __fadd_rn(__fadd_rn(s[c], s[3 + c]), s[6 + c]);
                dst[REC + c] = __fsub_rn(s[12 + c], __fmul_rn(CLIP_EPS, sum));
            }
        }
        __syncthreads();
        if (in_image) {
            for (int k = 0; k < n; ++k) {
                const float* s = s_rec[k];
                const float a0 = affine(s + 0, fx, fy);
                const float a1 = affine(s + 3, fx, fy);
                const float a2 = affine(s + 6, fx, fy);
                const bool cov = inside_edge(a0, s + 0) && inside_edge(a1, s + 3) &&
                                 inside_edge(a2, s + 6);
                const float pz = affine(s + 9, fx, fy);
                const float pw = affine(s + 12, fx, fy);
                const float cut = affine(s + 16, fx, fy);
                const float idf = s[15];
                const bool ok = cov && (cut >= 0.0f) && (pw > 0.0f) && (fabsf(pz) <= pw) &&
                                (idf < ID_VALID_THRESH);
                if (ok) {
                    // Cross-multiplied depth order; equal depth -> lower id.
                    const float lhs = __fmul_rn(pz, aw);
                    const float rhs = __fmul_rn(az, pw);
                    if ((lhs < rhs) || ((lhs == rhs) && (idf < aid))) {
                        az = pz;
                        aw = pw;
                        aid = idf;
                        pa0 = a0;
                        pa1 = a1;
                        pa2 = a2;
                        if (DB) {
                            cx0 = s[1];
                            cy0 = s[2];
                            cx1 = s[4];
                            cy1 = s[5];
                            cx2 = s[7];
                            cy2 = s[8];
                        }
                    }
                }
            }
        }
        __syncthreads();
    }

    if (!in_image) return;
    // Final shading (rasterize_pallas.py, final grid step).
    const bool valid = aid < ID_VALID_THRESH;
    const float iw = 1.0f / __fadd_rn(__fadd_rn(pa0, pa1), pa2);
    float b0 = clip_nan(__fmul_rn(pa0, iw), 0.0f, 1.0f);
    float b1 = clip_nan(__fmul_rn(pa1, iw), 0.0f, 1.0f);
    const float bs = 1.0f / max_nan(__fadd_rn(b0, b1), 1.0f);
    b0 = __fmul_rn(b0, bs);
    b1 = __fmul_rn(b1, bs);
    const float zwv = clip_nan(az / aw, -1.0f, 1.0f);
    const size_t o = (static_cast<size_t>(b) * H + py) * W + px;
    u_out[o] = valid ? b0 : 0.0f;
    v_out[o] = valid ? b1 : 0.0f;
    zw_out[o] = valid ? zwv : 0.0f;
    idf_out[o] = valid ? aid : 0.0f;
    if (DB) {
        // Bary pixel derivatives (rasterize_pallas.py final step, emit_db).
        const float da0dx = -cx0, da1dx = -cx1, da2dx = -cx2;
        const float da0dy = -cy0, da1dy = -cy1, da2dy = -cy2;
        const float datdx = __fadd_rn(__fadd_rn(da0dx, da1dx), da2dx);
        const float datdy = __fadd_rn(__fadd_rn(da0dy, da1dy), da2dy);
        const float dfxdx = __fmul_rn(xs, iw);
        const float dfydy = __fmul_rn(ys, iw);
        const float dudx = __fmul_rn(dfxdx, __fsub_rn(__fmul_rn(b0, datdx), da0dx));
        const float dudy = __fmul_rn(dfydy, __fsub_rn(__fmul_rn(b0, datdy), da0dy));
        const float dvdx = __fmul_rn(dfxdx, __fsub_rn(__fmul_rn(b1, datdx), da1dx));
        const float dvdy = __fmul_rn(dfydy, __fsub_rn(__fmul_rn(b1, datdy), da1dy));
        dudx_out[o] = valid ? dudx : 0.0f;
        dudy_out[o] = valid ? dudy : 0.0f;
        dvdx_out[o] = valid ? dvdx : 0.0f;
        dvdy_out[o] = valid ? dvdy : 0.0f;
    }
}

}  // namespace

// rec [B, T, 16], aabb [B, T, 4] (16-byte aligned); outputs [B, H, W].
extern "C" int nvdr_rasterize_fwd(const float* rec, const float* aabb, float* u, float* v,
                                  float* zw, float* idf, int B, int T, int H, int W,
                                  float xs, float xo, float ys, float yo, void* stream) {
    if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
    const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
    raster_kernel<false><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        rec, reinterpret_cast<const float4*>(aabb), u, v, zw, idf, nullptr, nullptr, nullptr,
        nullptr, T, H, W, xs, xo, ys, yo);
    return static_cast<int>(cudaGetLastError());
}

// The emit_db variant: also writes dudx, dudy, dvdx, dvdy [B, H, W].
extern "C" int nvdr_rasterize_fwd_db(const float* rec, const float* aabb, float* u, float* v,
                                     float* zw, float* idf, float* dudx, float* dudy,
                                     float* dvdx, float* dvdy, int B, int T, int H, int W,
                                     float xs, float xo, float ys, float yo, void* stream) {
    if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
    const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
    raster_kernel<true><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        rec, reinterpret_cast<const float4*>(aabb), u, v, zw, idf, dudx, dudy, dvdx, dvdy, T, H,
        W, xs, xo, ys, yo);
    return static_cast<int>(cudaGetLastError());
}
