// Rasterizer record setup: per triangle the 16-float record, the screen
// AABB, the number of 16x16 tiles the AABB meets, and per chunk of 256
// records the union of their AABBs.
//
// Replaces: nvdiffrast_tpu/ops/rasterize_pallas.py, the XLA prepass that
// rasterize_fused runs inside its own call (_build_records_cm :177,
// _near_clip_cols, _coverage_slop*, _aabb_union_cols). Its plain twin and
// CPU path is ops/rasterize_cuda.py build_records, ~200 torch ops.
//
// One thread per (set, triangle), one block per chunk of 256 triangles
// of one set. Every line follows the twin's float32 operation order:
// the edge rows come from the correctly-rounded difference of products
// (one f64 subtraction of exact f64 products, one conversion to f32),
// the z / w planes and the winding sign from three-term f32 sums, then
// the near-plane clip into <= 2 sub-triangles, the coverage slop from
// the edge coefficients, and the pixel-unit AABB with the half-pixel
// guard band (band-local rows under a viewport). The file is built with
// -fmad=false and nvcc's IEEE defaults (no -ftz, -prec-div, -prec-sqrt),
// and the rounding-sensitive lines spell __fmul_rn / __fadd_rn /
// __fdiv_rn / __fsqrt_rn; the constants are the float32 roundings of the
// twin's Python doubles (1e-38 stays a subnormal). So the kernel equals
// build_records bit for bit.
//
// Also written here, for the sweep and the binning (rasterize.cu,
// raster_bin.cu): counts[s, t], the tiles the AABB meets by the sweep's
// own tile test, and boxes[s, c], the union
// AABB of records [256c, 256c + 256): the unbinned sweep skips a whole
// chunk whose box misses its tile. min / max are exact, so the boxes do
// not depend on the reduction order. A triangle index outside [0, V)
// (the wrapper checks the indices before the launch) makes the triangle
// invalid rather than reading out of bounds.
//
// Bound on the H100: bytes. It reads 3 vertices (48 bytes, gathered)
// and one index triple a triangle and writes 16 + 4 floats and a count;
// ~400 float operations a triangle (the slop and the clip lead) are far
// below the float32 rate, so at 1 M triangles the floor is ~0.03 ms of
// device-memory traffic.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;   // rasterize.cu TILE
constexpr int CHUNK = 256; // records a chunk box (rasterize.cu NT); = threads a block

// The twin's Python constants as torch rounds them into float32.
__device__ __forceinline__ float big() { return static_cast<float>(1e30); }
constexpr double W_CLIP_EPS = 1e-9;                    // rasterize._W_CLIP_EPS
constexpr double SLOP_KAPPA = (1.01 + 3.0) * 0x1p-24;
constexpr double SLOP_ABS_FLOOR = 3.0 * 0x1p-126;
constexpr double SLOP_MARGIN = 1.25;

// torch.clamp / torch.minimum / torch.maximum: a NaN operand propagates.
__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
    return x != x ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float min_nan(float x, float y) {
    return (x != x || y != y) ? __fadd_rn(x, y) : fminf(x, y);
}
__device__ __forceinline__ float max_nan(float x, float y) {
    return (x != x || y != y) ? __fadd_rn(x, y) : fmaxf(x, y);
}

// rasterize._dop: fl(a*b - c*d) with one f64 rounding, then f32.
__device__ __forceinline__ float dop(float a, float b, float c, float d) {
    const double ab = __dmul_rn(static_cast<double>(a), static_cast<double>(b));
    const double cd = __dmul_rn(static_cast<double>(c), static_cast<double>(d));
    return __double2float_rn(__dsub_rn(ab, cd));
}

// (a0 * b0 + a1 * b1) + a2 * b2, each operation rounded on its own.
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2,
                                      float b2) {
    return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

struct V3 {
    float x, y, w;
};

// isect of _near_clip_cols: p + t (q - p), t = clip((eps - p.w) / safe, 0, 1).
__device__ __forceinline__ V3 isect(V3 p, V3 q) {
    const float eps = static_cast<float>(W_CLIP_EPS);
    const float denom = __fsub_rn(q.w, p.w);
    const float safe = fabsf(denom) > 0.0f ? denom : 1.0f;
    const float t = clip_nan(__fdiv_rn(__fsub_rn(eps, p.w), safe), 0.0f, 1.0f);
    return {__fadd_rn(p.x, __fmul_rn(t, __fsub_rn(q.x, p.x))),
            __fadd_rn(p.y, __fmul_rn(t, __fsub_rn(q.y, p.y))),
            __fadd_rn(p.w, __fmul_rn(t, __fsub_rn(q.w, p.w)))};
}

// rasterize_cuda._tile_span (exact in double): tiles [first, last] of an
// n-tile axis whose pixels [16t, 16t + 15] meet [lo, hi]; last < first
// when none.
__device__ __forceinline__ int tile_count(float lo, float hi, int n) {
    double f = ceil((static_cast<double>(lo) - (TILE - 1)) / TILE);
    double l = floor(static_cast<double>(hi) / TILE);
    if (!(f == f) || !(l == l)) return 0;
    f = f < 0.0 ? 0.0 : (f > n ? static_cast<double>(n) : f);
    l = l < -1.0 ? -1.0 : (l > n - 1 ? static_cast<double>(n - 1) : l);
    return f <= l ? static_cast<int>(l - f) + 1 : 0;
}

struct Box {
    float x0, y0, x1, y1;
};

// One slot of _aabb_union_cols: the pixel-unit box of the (clipped)
// triangle s[0..2], plus the guard band; empty when not ok.
__device__ __forceinline__ Box slot_box(const V3* s, bool slot_ok, float gx, float gy,
                                        float hw, float hh, float y0f, int H, int W) {
    float px[3], py[3];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
        const float wv = max_nan(s[v].w, static_cast<float>(1e-12));
        px[v] = clip_nan(__fsub_rn(__fmul_rn(__fadd_rn(__fdiv_rn(s[v].x, wv), 1.0f), hw), 0.5f),
                         -1e9f, 1e9f);
        py[v] = clip_nan(__fsub_rn(__fsub_rn(__fmul_rn(__fadd_rn(__fdiv_rn(s[v].y, wv), 1.0f), hh),
                                             0.5f),
                                   y0f),
                         -1e9f, 1e9f);
    }
    const float xmin = __fsub_rn(min_nan(min_nan(px[0], px[1]), px[2]), gx);
    const float xmax = __fadd_rn(max_nan(max_nan(px[0], px[1]), px[2]), gx);
    const float ymin = __fsub_rn(min_nan(min_nan(py[0], py[1]), py[2]), gy);
    const float ymax = __fadd_rn(max_nan(max_nan(py[0], py[1]), py[2]), gy);
    const float wlim = static_cast<float>(static_cast<double>(W) - 0.5);
    const float hlim = static_cast<float>(static_cast<double>(H) - 0.5);
    const bool onscreen = (xmax >= -0.5f) && (xmin <= wlim) && (ymax >= -0.5f) && (ymin <= hlim);
    if (slot_ok && onscreen) return {xmin, ymin, xmax, ymax};
    return {big(), big(), -big(), -big()};
}

__global__ void __launch_bounds__(CHUNK)
raster_setup_kernel(const float4* __restrict__ pos, const int* __restrict__ tri,
                    float4* __restrict__ rec, float4* __restrict__ aabb, int* __restrict__ counts,
                    float4* __restrict__ boxes, int V, int T, int H, int W, int y0, int Hf) {
    __shared__ float4 s_red[CHUNK / 32];
    const int s = blockIdx.y;
    const int t = blockIdx.x * CHUNK + threadIdx.x;
    Box box = {big(), big(), -big(), -big()};

    if (t < T) {
        int idx[3];
        bool in_range = true;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            idx[j] = tri[3 * t + j];
            in_range = in_range && idx[j] >= 0 && idx[j] < V;
        }
        float x[3], y[3], z[3], w[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const float4 p = in_range ? pos[static_cast<size_t>(s) * V + idx[j]]
                                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            x[j] = p.x;
            y[j] = p.y;
            z[j] = p.z;
            w[j] = p.w;
        }
        // Edge k opposite vertex k, (c0, cx, cy): (1, 2), (2, 0), (0, 1).
        float e[3][3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const int j = (k + 1) % 3, kk = (k + 2) % 3;
            e[k][0] = dop(x[j], y[kk], x[kk], y[j]);
            e[k][1] = dop(y[j], w[kk], w[j], y[kk]);
            e[k][2] = dop(w[j], x[kk], x[j], w[kk]);
        }
        float zc[3], wc[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            zc[c] = dot3(z[0], e[0][c], z[1], e[1][c], z[2], e[2][c]);
            wc[c] = dot3(w[0], e[0][c], w[1], e[1][c], w[2], e[2][c]);
        }
        const float pD = dot3(e[0][0], w[0], e[0][1], x[0], e[0][2], y[0]);
        const float po = pD < 0.0f ? -1.0f : 1.0f;

        // Near-plane clip (w >= eps) into <= 2 sub-triangles.
        const float eps = static_cast<float>(W_CLIP_EPS);
        const bool in0 = w[0] >= eps, in1 = w[1] >= eps, in2 = w[2] >= eps;
        const int n_in = static_cast<int>(in0) + static_cast<int>(in1) + static_cast<int>(in2);
        const int k_one = in0 ? 0 : (in1 ? 1 : 2);
        const int k_two = !in2 ? 0 : (!in0 ? 1 : 2);
        const int rk = n_in == 1 ? k_one : (n_in == 2 ? k_two : 0);
        V3 r[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const int q = (j + rk) % 3;
            r[j] = {x[q], y[q], w[q]};
        }
        const V3 i01 = isect(r[0], r[1]);
        const V3 i02 = isect(r[0], r[2]);
        const V3 i12 = isect(r[1], r[2]);
        const bool case_one = n_in == 1, case_two = n_in == 2;
        const V3 s0[3] = {r[0], case_one ? i01 : r[1], case_one ? i02 : (case_two ? i12 : r[2])};
        const V3 s1[3] = {r[0], i12, i02};

        auto same = [&](int j, int k) { return x[j] == x[k] && y[j] == y[k] && w[j] == w[k]; };
        const bool dup = same(0, 1) || same(1, 2) || same(2, 0);
        const bool valid = in_range && (pD != 0.0f) && !dup && (n_in >= 1);

        // Coverage slop from the (unnormalized) edge coefficients.
        float ek[3], gk[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const float l1 =
                __fadd_rn(__fadd_rn(fabsf(e[k][0]), fabsf(e[k][1])), fabsf(e[k][2]));
            ek[k] = __fadd_rn(__fmul_rn(static_cast<float>(SLOP_KAPPA), l1),
                              static_cast<float>(SLOP_ABS_FLOOR));
            gk[k] = __fsqrt_rn(__fadd_rn(__fmul_rn(e[k][1], e[k][1]), __fmul_rn(e[k][2], e[k][2])));
        }
        float slop = 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const int l = (k + 1) % 3;
            const float d =
                fabsf(__fsub_rn(__fmul_rn(e[k][1], e[l][2]), __fmul_rn(e[k][2], e[l][1])));
            const float num = __fadd_rn(__fmul_rn(ek[k], gk[l]), __fmul_rn(ek[l], gk[k]));
            const float delta =
                d > 0.0f ? __fdiv_rn(num, max_nan(d, static_cast<float>(1e-38))) : big();
            slop = max_nan(slop, delta);
        }
        slop = __fmul_rn(static_cast<float>(SLOP_MARGIN), slop);

        // Pixel-unit AABB of the clipped slots, with the guard band.
        const float hw = static_cast<float>(static_cast<double>(W) * 0.5);
        const float hh = static_cast<float>(static_cast<double>(Hf) * 0.5);
        const float gx = __fadd_rn(0.5f, clip_nan(__fmul_rn(slop, hw), 0.0f, 1e9f));
        const float gy = __fadd_rn(0.5f, clip_nan(__fmul_rn(slop, hh), 0.0f, 1e9f));
        const float y0f = static_cast<float>(y0);
        const Box b0 = slot_box(s0, valid && n_in >= 1, gx, gy, hw, hh, y0f, H, W);
        const Box b1 = slot_box(s1, valid && case_two, gx, gy, hw, hh, y0f, H, W);
        box = {fminf(b0.x0, b1.x0), fminf(b0.y0, b1.y0), fmaxf(b0.x1, b1.x1),
               fmaxf(b0.y1, b1.y1)};

        // Record rows, winding-normalized; id + 1, or 1e30 when invalid.
        float row[16];
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int c = 0; c < 3; ++c) row[3 * k + c] = valid ? __fmul_rn(e[k][c], po) : 0.0f;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            row[9 + c] = valid ? __fmul_rn(zc[c], po) : 0.0f;
            row[12 + c] = valid ? __fmul_rn(wc[c], po) : 0.0f;
        }
        row[15] = valid ? __fadd_rn(static_cast<float>(t), 1.0f) : big();
        const size_t o = static_cast<size_t>(s) * T + t;
#pragma unroll
        for (int q = 0; q < 4; ++q)
            rec[4 * o + q] =
                make_float4(row[4 * q], row[4 * q + 1], row[4 * q + 2], row[4 * q + 3]);
        aabb[o] = make_float4(box.x0, box.y0, box.x1, box.y1);
        counts[o] = tile_count(box.x0, box.x1, (W + TILE - 1) / TILE) *
                    tile_count(box.y0, box.y1, (H + TILE - 1) / TILE);
    }

    // Chunk box: min / max over the block's records (exact, order-free).
    float4 u = make_float4(box.x0, box.y0, box.x1, box.y1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        u.x = fminf(u.x, __shfl_xor_sync(0xffffffffu, u.x, off));
        u.y = fminf(u.y, __shfl_xor_sync(0xffffffffu, u.y, off));
        u.z = fmaxf(u.z, __shfl_xor_sync(0xffffffffu, u.z, off));
        u.w = fmaxf(u.w, __shfl_xor_sync(0xffffffffu, u.w, off));
    }
    if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = u;
    __syncthreads();
    if (threadIdx.x == 0) {
        float4 v = s_red[0];
        for (int q = 1; q < CHUNK / 32; ++q) {
            v.x = fminf(v.x, s_red[q].x);
            v.y = fminf(v.y, s_red[q].y);
            v.z = fmaxf(v.z, s_red[q].z);
            v.w = fmaxf(v.w, s_red[q].w);
        }
        boxes[static_cast<size_t>(s) * gridDim.x + blockIdx.x] = v;
    }
}

}  // namespace

// pos [S, V, 4] float32 (16-byte aligned; S = 1 in range mode), tri [T, 3]
// int32 -> rec [S, T, 16], aabb [S, T, 4] float32, counts [S, T] int32,
// boxes [S, ceil(T / 256), 4] float32. (H, W): the band's resolution;
// y0, Hf: its first row and the full image height (H and 0 without a
// viewport).
extern "C" int nvdr_raster_setup(const float* pos, const int* tri, float* rec, float* aabb,
                                 int* counts, float* boxes, int S, int V, int T, int H, int W,
                                 int y0, int Hf, void* stream) {
    if (S <= 0 || T <= 0) return static_cast<int>(cudaGetLastError());
    const dim3 grid((T + CHUNK - 1) / CHUNK, S);
    raster_setup_kernel<<<grid, CHUNK, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(pos), tri, reinterpret_cast<float4*>(rec),
        reinterpret_cast<float4*>(aabb), counts, reinterpret_cast<float4*>(boxes), V, T, H, W,
        y0, Hf);
    return static_cast<int>(cudaGetLastError());
}
