// Rasterizer: coverage, depth test and shading to (u, v, z/w, id) in one
// pass over per-triangle records.
//
// Replaces: nvdiffrast_tpu/ops/rasterize_pallas.py, rasterize_fused with
// its kernel body _make_kernel, in all its modes: instance and range
// mode, with and without emit_db, the zbuf output, the peel cull,
// viewport bands, and the binned sweep that takes the place of the TPU's
// dense / remap / CSR layouts. The db variant also keeps the winner's
// six edge gradients (cx0, cy0, cx1, cy1, cx2, cy2) in registers and
// writes the four bary pixel derivatives (dudx, dudy, dvdx, dvdy) in the
// final step.
//
// Input: records [S, T, 16] f32 built by the prepass in
// ops/rasterize_cuda.py (3 winding-normalized affine edge functions
// (c, d/dfx, d/dfy), the z plane, the w plane, id+1 or 1e30 when
// invalid) and their screen AABBs [S, T, 4] (xmin, ymin, xmax, ymax in
// band-local pixel-index units, coverage slop included; empty =
// (+1e30, -1e30)). S = B in instance mode (one set per image) and S = 1
// in range mode, where every image reads the one set and masks ids
// against its [start, start + count) window of ranges [B, 2].
//
// Design: one block per 16x16 pixel tile and image, one thread per
// pixel. The block streams its candidate records through shared memory
// 256 at a time: unbinned, every record of the set, each thread testing
// one record's AABB against the tile; binned, only the tile's own
// segment of the per-tile lists of raster_bin.cu (ascending record
// index, exactly the records whose AABB meets the tile by the same
// test). A warp-ballot compaction keeps the candidates in id order, so
// every pixel merges them in ascending id order, and the binned sweep
// equals the unbinned one bit for bit. The running (pz, pw, id, a0, a1,
// a2) state lives in registers; the outputs are written once.
//
// Modes, all arguments of one kernel (null pointer = off; db, binning
// and peel also pick one of 8 compiled variants):
//   ranges  range-mode id windows (float bounds start+1, start+1+count);
//   peel    [B, H, W] previous layer's zbuf; a fragment survives only if
//           fl(pz / pw) > peel. The IEEE quotient is the one the zbuf
//           output stores, so the previous winner is culled exactly;
//   zbuf    [B, H, W] output, pz / pw of the winner, +inf where empty;
//   y0      viewport: pixel row py of the band is row py + y0 of the
//           full image (xs, xo, ys, yo come from the full height).
//
// Bound on the H100: instruction throughput of the per-pixel edge
// evaluations (~34 operations a fragment) and, unbinned, of the
// per-record AABB tests (T * tiles of them, which dominate for big
// meshes); device-memory traffic is the record stream (L2 resident) and
// one write of each output per pixel.
//
// Rounding: built with -fmad=false, and the lines where coverage
// depends on the last bit use __fmul_rn/__fadd_rn/__fdiv_rn explicitly,
// in the operation order of the reference, so the plain PyTorch twin
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

struct Args {
    const float* rec;         // [S, T, 16]
    const float4* aabb;       // [S, T, 4]
    const int* tile_start;    // [S * tiles + 1] segment starts (binned)
    const int* tile_list;     // [E] record index within its set (binned)
    const int* ranges;        // [B, 2] (start, count) or null
    const float* peel;        // [B, H, W] or null
    float* out[9];            // u, v, zw, idf, dudx, dudy, dvdx, dvdy, zbuf
    int T, sets, H, W, y0;
    float xs, xo, ys, yo;
};

template <bool DB, bool BINNED, bool PEEL>
__global__ void __launch_bounds__(NT) raster_kernel(const Args a) {
    __shared__ float s_rec[NT][SREC];
    __shared__ int s_count[NT / 32];

    const int b = blockIdx.z;
    const int set = a.sets > 1 ? b : 0;
    const int tx0 = blockIdx.x * TILE;
    const int ty0 = blockIdx.y * TILE;
    const int px = tx0 + (threadIdx.x % TILE);
    const int py = ty0 + (threadIdx.x / TILE);
    const bool in_image = (px < a.W) && (py < a.H);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int T = a.T;

    // Pixel center in clip space, (p * s) + o, on the full image's row.
    const float fx = __fadd_rn(__fmul_rn(static_cast<float>(px), a.xs), a.xo);
    const float fy = __fadd_rn(__fmul_rn(static_cast<float>(py + a.y0), a.ys), a.yo);
    const float ftx0 = static_cast<float>(tx0);
    const float ftx1 = static_cast<float>(tx0 + TILE - 1);
    const float fty0 = static_cast<float>(ty0);
    const float fty1 = static_cast<float>(ty0 + TILE - 1);

    // Range-mode id window as float bounds (ids are +1); all ids pass
    // without ranges.
    float start_f = 0.0f, end_f = 2.0f * ID_VALID_THRESH;
    if (a.ranges != nullptr) {
        start_f = __fadd_rn(static_cast<float>(a.ranges[2 * b]), 1.0f);
        end_f = __fadd_rn(start_f, static_cast<float>(a.ranges[2 * b + 1]));
    }
    const float peel =
        (PEEL && in_image) ? a.peel[(static_cast<size_t>(b) * a.H + py) * a.W + px] : 0.0f;

    // Running lexicographic (z/w, id) minimum and the winner's edges.
    float az = BIG, aw = 1.0f, aid = ID_INVALID;
    float pa0 = 0.0f, pa1 = 0.0f, pa2 = 0.0f;
    // Winner's edge gradients (d/dfx, d/dfy of each edge), DB only.
    float cx0 = 0.0f, cy0 = 0.0f, cx1 = 0.0f, cy1 = 0.0f, cx2 = 0.0f, cy2 = 0.0f;

    const float* rec_s = a.rec + static_cast<size_t>(set) * T * REC;
    const float4* aabb_s = a.aabb + static_cast<size_t>(set) * T;

    // Candidate stream: [lo, hi) of the tile's segment, or every record.
    int lo = 0, hi = T;
    if (BINNED) {
        const int seg = (set * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
        lo = a.tile_start[seg];
        hi = a.tile_start[seg + 1];
    }

    for (int base = lo; base < hi; base += NT) {
        const int j = base + threadIdx.x;
        bool hit = false;
        int i = 0;
        if (j < hi) {
            if (BINNED) {
                i = a.tile_list[j];
                hit = true;
            } else {
                i = j;
                const float4 bb = aabb_s[i];
                hit = (bb.y <= fty1) && (bb.w >= fty0) && (bb.x <= ftx1) && (bb.z >= ftx0);
            }
            if (hit && a.ranges != nullptr) {
                const float idf = rec_s[static_cast<size_t>(i) * REC + 15];
                hit = (idf >= start_f) && (idf < end_f);
            }
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
            const float4* src = reinterpret_cast<const float4*>(rec_s + static_cast<size_t>(i) * REC);
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
                // Rounded-depth peel cull (pw > 0 is tested first).
                const bool ok = cov && (cut >= 0.0f) && (pw > 0.0f) && (fabsf(pz) <= pw) &&
                                (idf < ID_VALID_THRESH) &&
                                (!PEEL || __fdiv_rn(pz, pw) > peel);
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
    const float depth = __fdiv_rn(az, aw);
    const size_t o = (static_cast<size_t>(b) * a.H + py) * a.W + px;
    a.out[0][o] = valid ? b0 : 0.0f;
    a.out[1][o] = valid ? b1 : 0.0f;
    a.out[2][o] = valid ? clip_nan(depth, -1.0f, 1.0f) : 0.0f;
    a.out[3][o] = valid ? aid : 0.0f;
    if (a.out[8] != nullptr) a.out[8][o] = valid ? depth : INFINITY;
    if (DB) {
        // Bary pixel derivatives (rasterize_pallas.py final step, emit_db).
        const float da0dx = -cx0, da1dx = -cx1, da2dx = -cx2;
        const float da0dy = -cy0, da1dy = -cy1, da2dy = -cy2;
        const float datdx = __fadd_rn(__fadd_rn(da0dx, da1dx), da2dx);
        const float datdy = __fadd_rn(__fadd_rn(da0dy, da1dy), da2dy);
        const float dfxdx = __fmul_rn(a.xs, iw);
        const float dfydy = __fmul_rn(a.ys, iw);
        const float dudx = __fmul_rn(dfxdx, __fsub_rn(__fmul_rn(b0, datdx), da0dx));
        const float dudy = __fmul_rn(dfydy, __fsub_rn(__fmul_rn(b0, datdy), da0dy));
        const float dvdx = __fmul_rn(dfxdx, __fsub_rn(__fmul_rn(b1, datdx), da1dx));
        const float dvdy = __fmul_rn(dfydy, __fsub_rn(__fmul_rn(b1, datdy), da1dy));
        a.out[4][o] = valid ? dudx : 0.0f;
        a.out[5][o] = valid ? dudy : 0.0f;
        a.out[6][o] = valid ? dvdx : 0.0f;
        a.out[7][o] = valid ? dvdy : 0.0f;
    }
}

}  // namespace

// The one entry point of every mode (ops/rasterize_cuda.py picks the mode
// and keeps a launch count per mode):
//   rec [S, T, 16], aabb [S, T, 4] (16-byte aligned; S = sets, 1 or B);
//   tile_start [S * tiles + 1], tile_list [E] (both null: unbinned);
//   ranges [B, 2] int32 or null; peel [B, H, W] or null;
//   u, v, zw, idf [B, H, W]; dudx, dudy, dvdx, dvdy [B, H, W] or all
//   null (no db); zbuf [B, H, W] or null.
extern "C" int nvdr_rasterize(const float* rec, const float* aabb, const int* tile_start,
                              const int* tile_list, const int* ranges, const float* peel,
                              float* u, float* v, float* zw, float* idf, float* dudx,
                              float* dudy, float* dvdx, float* dvdy, float* zbuf, int B, int T,
                              int sets, int H, int W, int y0, float xs, float xo, float ys,
                              float yo, void* stream) {
    if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
    if ((tile_start == nullptr) != (tile_list == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const bool binned = tile_list != nullptr;
    Args a{rec, reinterpret_cast<const float4*>(aabb), tile_start, tile_list, ranges, peel,
           {u, v, zw, idf, dudx, dudy, dvdx, dvdy, zbuf}, T, sets, H, W, y0, xs, xo, ys, yo};
    const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // The 8 variants: db, binned and peel are compile-time flags.
    const int variant = (dudx != nullptr) | (binned << 1) | ((peel != nullptr) << 2);
    switch (variant) {
        case 0: raster_kernel<false, false, false><<<grid, NT, 0, s>>>(a); break;
        case 1: raster_kernel<true, false, false><<<grid, NT, 0, s>>>(a); break;
        case 2: raster_kernel<false, true, false><<<grid, NT, 0, s>>>(a); break;
        case 3: raster_kernel<true, true, false><<<grid, NT, 0, s>>>(a); break;
        case 4: raster_kernel<false, false, true><<<grid, NT, 0, s>>>(a); break;
        case 5: raster_kernel<true, false, true><<<grid, NT, 0, s>>>(a); break;
        case 6: raster_kernel<false, true, true><<<grid, NT, 0, s>>>(a); break;
        default: raster_kernel<true, true, true><<<grid, NT, 0, s>>>(a); break;
    }
    return static_cast<int>(cudaGetLastError());
}
