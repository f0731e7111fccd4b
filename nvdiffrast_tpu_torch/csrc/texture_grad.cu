// Texture gradient: the colour cotangent of every pixel's bilinear taps
// summed into the packed mip pyramid, deterministic.
//
// Replaces: nvdiffrast_tpu/ops/lattice_scatter.py, _sep_kernel_call with
// its pair-list setup (lattice_scatter_grad) and the border fold
// (fold_ext_grad_sep); for per-image textures also the generic path the
// JAX package takes instead (texture_pallas.py _sample_bwd's
// generic_path through scatter.py's _scatter_pallas).
//
// The TPU kernel runs one f32 matmul per (texel tile, pixel chunk) pair
// of a separable one-hot stamp on an apron pyramid, then folds the apron
// back per boundary mode. On this card the taps are summed by texel
// instead, with no apron and no float atomics, so the gradient is the
// same on every run. A tap is one (pixel p, code (slot*2 + dv)*2 + du):
// it adds ((lw * vw_dv) * gc_c) * uw_du, computed in float32 in the
// reference's order (level_weights, lattice_setup_sep), to the texel its
// corner resolves to (wrap by modulo, clamp by clamping; the zero
// boundary's outside corners and the taps whose weight factors are 0 are
// left out: they add exactly 0 to a sum that starts at +0).
//
// What bounds it on the H100, and the design. A 2048^2 frame has 8N =
// 33.5 M taps; sorting them all by texel costs far more than the sums
// (6.0-7.4 ms of index glue with two host syncs at the bench scene).
// But neighbouring pixels tap neighbouring texels: magnified, a covered
// 16x16 tile's 1,024 taps fall on ~30 texels, and every background pixel
// samples uv = (0, 0), so a background tile's fall on 4. So the taps are
// pre-reduced where they are made, per screen tile, and only the
// (texel, tile) partial sums, a few hundred thousand, are sorted:
//   tiles   one block per 16x16 tile and image, one thread per pixel,
//           computes its 8 taps and radix-sorts the tile's 2,048
//           (key, pixel*8 + code) pairs in shared memory
//           (cub::BlockRadixSort, stable, over only the bits of the
//           tile's key range). The key is the tap's unwrapped lattice
//           cell (slot, level, row, column) within the box those cells
//           span in the tile: a few bits (a background tile's 4 cells
//           need 3, a magnified one's ~36 need 6), where the texel index,
//           split by the wrap seam, would need 12-19. One warp per run of
//           equal keys sums its taps in float64 (lane l takes the l-th,
//           (l+32)-th, ... tap of the run, then a fixed butterfly of
//           shuffles) into an entry (its texel and C partial sums).
//           Two cells of a tile that resolve to one texel (the wrap seam,
//           a clamped border) stay two entries of that texel. A tile
//           whose pixels all sample one (u, v, flevel) (the background, at
//           uv = (0, 0)) skips the sort: warp k sums code k. The block
//           writes its entry count and, up to CAP = 64 of them (~15 on
//           average at the bench scene), the entries to its own slots of
//           a scratch;
//   (the wrapper scans the counts and reads the total back to the host
//           once, to allocate the entries: the one host sync)
//   compact (segment_sum.cu) moves each tile's entries from its scratch
//           slots to its scan offset, in run order, and the tiles kernel
//           runs again for the few tiles of more than CAP entries,
//           writing there directly (the others return at once);
//   (a stable torch.sort of the entries' int32 texels: texel-major, then
//           tile, then run, as the entries were written tile-major)
//   segment_starts (raster_bin.cu) the first entry of every texel;
//   sums    (segment_sum.cu) each texel's entries added in float64 in
//           sorted order, by stretches of 16 and then per texel, and
//           rounded to float32 once; a hot texel takes a whole warp.
// Every float64 sum has a fixed order given the inputs (the sort is
// stable; lanes and runs are fixed partitions of sorted positions),
// so the result is bitwise repeatable; the twin texture_grad_plain sums
// the same float32 tap values with float64 index_add_ and rounds once,
// so the two agree within 1 float32 ulp. A hot texel (the 4 background
// texels collect an entry from each of ~9,000 tiles) costs the sums
// E / (32 * 16) loads a lane, not E.
//
// Bytes: u, v, flevel and C cotangents of every pixel, the entries (4 +
// 8C bytes each, written, moved, sorted, read back) and the [n_texels, C]
// output; operations: ~30 float32 a tap and C float64 adds a kept tap,
// below the card's rates. The bound is the pixel streams' bytes, ~0.03 ms
// at 2048^2 with C = 3.
#include <cuda_runtime.h>

#include <cstdint>

#include <cub/block/block_radix_sort.cuh>

#include "segment_sum.cuh"
#include "texture_corner.cuh"

namespace {

using namespace nvdr_tex;
using nvdr_seg::warp_sum;

constexpr int TILE = 16;           // screen tile edge (texture_bwd_cuda.GRAD_TILE)
constexpr int NT = TILE * TILE;    // threads a block, one pixel each
constexpr int CODES = 8;           // taps a pixel: (slot, dv, du)
constexpr int ITEMS = NT * CODES;  // taps a tile
constexpr int CAP = 64;            // entries a tile keeps in the scratch (GRAD_CAP)

// One mip slot of a pixel (lattice_setup_sep): its level, the base cell
// (jv, ju) of its 2x2 corners before wrap / clamp, the fractions and the
// level weight; lev < 0 when the filter has no such slot or the pixel
// lies outside the image.
struct Slot {
    int lev, jv, ju, hl, wl, base;
    float lw, fu, fv;
};

__device__ __forceinline__ Slot slot_setup(float u, float v, float fl, int s, int L, int filter,
                                           int boundary, int tz, const Levels& lv) {
    Slot sl;
    sl.lev = -1;
    if (s == 1 && filter != MIP_LINEAR) return sl;
    int l0, l1;
    float frac;
    level_weights(filter != LINEAR ? fl : 0.0f, L, filter, l0, l1, frac);
    sl.lev = s == 0 ? l0 : l1;
    sl.lw = filter == MIP_LINEAR ? (s == 0 ? __fsub_rn(1.0f, frac) : frac) : 1.0f;
    sl.hl = lv.h[sl.lev];
    sl.wl = lv.w[sl.lev];
    sl.base = lv.off[sl.lev] + tz * sl.hl * sl.wl;
    const float w = static_cast<float>(sl.wl);
    const float h = static_cast<float>(sl.hl);
    if (boundary == WRAP) {
        u = __fsub_rn(u, floorf(u));
        v = __fsub_rn(v, floorf(v));
    }
    u = __fsub_rn(__fmul_rn(u, w), 0.5f);
    v = __fsub_rn(__fmul_rn(v, h), 0.5f);
    if (boundary == CLAMP) {
        u = clip_nan(u, 0.0f, __fsub_rn(w, 1.0f));
        v = clip_nan(v, 0.0f, __fsub_rn(h, 1.0f));
    }
    sl.ju = static_cast<int>(floorf(u));
    sl.jv = static_cast<int>(floorf(v));
    sl.fu = __fsub_rn(u, static_cast<float>(sl.ju));
    sl.fv = __fsub_rn(v, static_cast<float>(sl.jv));
    return sl;
}

// One tap: the texel (-1 when left out) and its weight factors.
struct Tap {
    int texel;
    float lwv, uw;
};

// Corner (dv, du) of a slot: texture_bwd_cuda.lattice_taps.
__device__ __forceinline__ Tap corner_tap(const Slot& sl, int dv, int du, int boundary) {
    Tap tp{-1, 0.0f, 0.0f};
    if (sl.lev < 0) return tp;
    int row = sl.jv + dv, col = sl.ju + du;
    const float vw0 = dv == 0 ? __fsub_rn(1.0f, sl.fv) : sl.fv;
    const float uw0 = du == 0 ? __fsub_rn(1.0f, sl.fu) : sl.fu;
    float vw = vw0, uw = uw0;
    bool ok = true;
    if (boundary == ZERO) {
        const bool okr = row >= 0 && row < sl.hl;
        const bool okc = col >= 0 && col < sl.wl;
        vw = __fmul_rn(vw0, okr ? 1.0f : 0.0f);
        uw = __fmul_rn(uw0, okc ? 1.0f : 0.0f);
        ok = okr && okc;
    } else if (boundary == WRAP) {
        // u - floor(u) lies in [0, 1], so row, col lie in [-1, h] x [-1, w]:
        // one conditional step is torch.remainder.
        row = row < 0 ? row + sl.hl : (row >= sl.hl ? row - sl.hl : row);
        col = col < 0 ? col + sl.wl : (col >= sl.wl ? col - sl.wl : col);
    } else {
        row = clampi(row, 0, sl.hl - 1);
        col = clampi(col, 0, sl.wl - 1);
    }
    const float lwv = __fmul_rn(sl.lw, vw);
    if (ok && lwv != 0.0f && uw != 0.0f) tp = {sl.base + row * sl.wl + col, lwv, uw};
    return tp;
}

// The block's tile and this thread's pixel.
struct TilePix {
    int blk, p, tz;
    bool in_image;
};

__device__ __forceinline__ TilePix tile_pixel(int H, int W, int per_image) {
    TilePix t;
    const int b = blockIdx.z;
    const int x = blockIdx.x * TILE + threadIdx.x % TILE;
    const int y = blockIdx.y * TILE + threadIdx.x / TILE;
    t.blk = (b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    t.in_image = x < W && y < H;
    t.p = (b * H + y) * W + x;
    t.tz = per_image ? b : 0;
    return t;
}

// The pixel's two slots (lev < 0 for an absent one or outside the image).
__device__ __forceinline__ void pixel_slots(const TilePix& t, const float* u, const float* v,
                                            const float* flevel, int L, int filter, int boundary,
                                            const Levels& lv, Slot* sl) {
    sl[0].lev = sl[1].lev = -1;
    if (!t.in_image) return;
    const float pu = u[t.p], pv = v[t.p], fl = filter != LINEAR ? flevel[t.p] : 0.0f;
    sl[0] = slot_setup(pu, pv, fl, 0, L, filter, boundary, t.tz, lv);
    sl[1] = slot_setup(pu, pv, fl, 1, L, filter, boundary, t.tz, lv);
}

// The tile's sort keys. Taps are grouped by their unwrapped lattice cell
// (slot, level, row, column): within a tile these span a small box, so
// the key needs a few bits where the texel index (row-major over the
// pyramid, split by the wrap seam) needs 12-19. Two cells of one tile
// may resolve to one texel (the wrap seam, the clamped border); they
// stay two entries of that texel.
// Should the box hold 2^31 cells or more, the key is the texel less the
// tile's smallest (always < 2^31). The box of a slot spans the base cells
// of the pixels with a kept corner in that slot, one more row and column.
struct Frame {
    int lmin[2], rmin[2], cmin[2];
    long long rr[2], cc[2], base1;
    int tmin;
    bool by_texel;
    unsigned range;  // keys lie in [0, range); range is the sentinel
};

constexpr int NRED = 14;  // per slot lmin, rmin, cmin, -lmax, -rmax, -cmax; tmin, -tmax

__device__ __forceinline__ unsigned tap_key(const Slot& sl, const Tap& tp, int k, const Frame& f) {
    if (tp.texel < 0) return f.range;
    if (f.by_texel) return static_cast<unsigned>(tp.texel - f.tmin);
    const int s = k >> 2, dv = (k >> 1) & 1, du = k & 1;
    const long long cell = ((static_cast<long long>(sl.lev - f.lmin[s]) * f.rr[s] +
                             (sl.jv + dv - f.rmin[s])) * f.cc[s]) + (sl.ju + du - f.cmin[s]);
    return static_cast<unsigned>((s == 0 ? 0 : f.base1) + cell);
}

// The pixel's contribution to the frame: its slots with a kept corner
// (kept: bit k of the kept taps), and the kept taps' texel range.
__device__ __forceinline__ void frame_pixel(const Slot* sl, unsigned kept, int tmin, int tmax,
                                            int* m) {
#pragma unroll
    for (int i = 0; i < NRED; ++i) m[i] = 0x7fffffff;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        if (((kept >> (4 * s)) & 15u) == 0) continue;
        m[6 * s + 0] = sl[s].lev;
        m[6 * s + 1] = sl[s].jv;
        m[6 * s + 2] = sl[s].ju;
        m[6 * s + 3] = -sl[s].lev;
        m[6 * s + 4] = -(sl[s].jv + 1);
        m[6 * s + 5] = -(sl[s].ju + 1);
    }
    m[12] = tmin;
    m[13] = -tmax;
}

__device__ __forceinline__ Frame frame_reduce(int* m, int* s_red) {
#pragma unroll
    for (int i = 0; i < NRED; ++i) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m[i] = min(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));
    }
    __syncthreads();
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
        for (int i = 0; i < NRED; ++i) s_red[(threadIdx.x >> 5) * NRED + i] = m[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NRED; ++i) {
#pragma unroll
        for (int w = 0; w < NT / 32; ++w) m[i] = min(m[i], s_red[w * NRED + i]);
    }
    Frame f;
    long long size[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        f.lmin[s] = m[6 * s];
        f.rmin[s] = m[6 * s + 1];
        f.cmin[s] = m[6 * s + 2];
        const bool any = m[6 * s] != 0x7fffffff;
        const long long ll = any ? static_cast<long long>(-m[6 * s + 3]) - m[6 * s] + 1 : 0;
        f.rr[s] = any ? static_cast<long long>(-m[6 * s + 4]) - m[6 * s + 1] + 1 : 0;
        f.cc[s] = any ? static_cast<long long>(-m[6 * s + 5]) - m[6 * s + 2] + 1 : 0;
        size[s] = (f.rr[s] > (1 << 24) || f.cc[s] > (1 << 24)) ? (1ll << 31)
                                                              : ll * f.rr[s] * f.cc[s];
    }
    f.base1 = size[0];
    f.tmin = m[12];
    const long long cells = size[0] + size[1];
    f.by_texel = cells >= (1ll << 31);
    f.range = f.by_texel ? static_cast<unsigned>(-m[13] - m[12]) + 1u
                         : static_cast<unsigned>(cells);
    return f;  // range == 0: no tap kept in the tile
}

// Whether every pixel of the tile lies in the image and samples the same
// (u, v, flevel) bit for bit, as the background does at uv = (0, 0): then
// all pixels share their taps, and each kept code is one entry.
__device__ __forceinline__ bool uniform_tile(const TilePix& t, const float* u, const float* v,
                                             const float* flevel, int filter, unsigned* s_q) {
    unsigned q[3] = {0u, 0u, 0u};
    if (t.in_image) {
        q[0] = __float_as_uint(u[t.p]);
        q[1] = __float_as_uint(v[t.p]);
        q[2] = filter != LINEAR ? __float_as_uint(flevel[t.p]) : 0u;
    }
    if (threadIdx.x == 0) {
        s_q[0] = q[0];
        s_q[1] = q[1];
        s_q[2] = q[2];
    }
    __syncthreads();
    return __syncthreads_and(t.in_image && q[0] == s_q[0] && q[1] == s_q[1] && q[2] == s_q[2]);
}

template <int C>
__global__ void __launch_bounds__(NT)
tex_grad_tiles(const float* __restrict__ u, const float* __restrict__ v,
               const float* __restrict__ flevel, const float* __restrict__ gc, int N, int H,
               int W, int L, int filter, int boundary, int per_image, Levels lv,
               const long long* __restrict__ offsets, int* __restrict__ counts,
               int* __restrict__ texel_out, double* __restrict__ part_out) {
    using Sort = cub::BlockRadixSort<unsigned, NT, CODES, unsigned short>;
    __shared__ union {
        typename Sort::TempStorage sort;
        struct {
            unsigned key[ITEMS];  // sorted keys; then the runs' starts
            unsigned short item[ITEMS];
        } s;
    } sm;
    __shared__ float s_lwv[ITEMS], s_uw[ITEMS];
    __shared__ float s_gc[C][NT];
    __shared__ int s_texel[ITEMS];  // by item; then by run
    __shared__ int s_red[NT / 32 * NRED];
    __shared__ int s_scan[NT / 32];
    __shared__ int s_nkept;
    __shared__ unsigned s_q[3];

    const TilePix t = tile_pixel(H, W, per_image);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // First pass (offsets null): write counts[tile] and, when they fit,
    // the entries to the tile's CAP slots of the scratch. Second pass:
    // only the tiles of more than CAP entries, at their offsets.
    const bool direct = offsets != nullptr;
    if (direct && counts[t.blk] <= CAP) return;  // uniform over the block
    const long long o0 = direct ? offsets[t.blk] : static_cast<long long>(t.blk) * CAP;
    Slot sl[2];
    pixel_slots(t, u, v, flevel, L, filter, boundary, lv, sl);
#pragma unroll
    for (int c = 0; c < C; ++c)
        s_gc[c][threadIdx.x] = t.in_image ? gc[static_cast<size_t>(c) * N + t.p] : 0.0f;
    unsigned kept = 0;
    int tmin = 0x7fffffff, tmax = -1;
#pragma unroll
    for (int k = 0; k < CODES; ++k) {
        const Tap tp = corner_tap(sl[k >> 2], (k >> 1) & 1, k & 1, boundary);
        s_lwv[threadIdx.x * CODES + k] = tp.lwv;
        s_uw[threadIdx.x * CODES + k] = tp.uw;
        s_texel[threadIdx.x * CODES + k] = tp.texel;
        if (tp.texel >= 0) {
            kept |= 1u << k;
            tmin = min(tmin, tp.texel);
            tmax = max(tmax, tp.texel);
        }
    }
    if (uniform_tile(t, u, v, flevel, filter, s_q)) {
        if (!direct && threadIdx.x == 0) counts[t.blk] = __popc(kept);
        // Warp k sums code k over the tile's pixels (lane l takes pixels
        // l, l+32, ...), entry number = the code's rank among the kept.
        const int k = warp;
        if ((kept >> k) & 1u) {
            const Tap tp = corner_tap(sl[k >> 2], (k >> 1) & 1, k & 1, boundary);
            double acc[C];
#pragma unroll
            for (int c = 0; c < C; ++c) acc[c] = 0.0;
            for (int p = lane; p < NT; p += 32) {
#pragma unroll
                for (int c = 0; c < C; ++c)
                    acc[c] += static_cast<double>(__fmul_rn(__fmul_rn(tp.lwv, s_gc[c][p]), tp.uw));
            }
#pragma unroll
            for (int c = 0; c < C; ++c) acc[c] = warp_sum(acc[c]);
            if (lane == 0) {
                const int r = __popc(kept & ((1u << k) - 1u));
                const long long o = o0 + r;
                texel_out[o] = tp.texel;
#pragma unroll
                for (int c = 0; c < C; ++c) part_out[o * C + c] = acc[c];
            }
        }
        return;
    }
    int m[NRED];
    frame_pixel(sl, kept, tmin, tmax, m);
    const Frame f = frame_reduce(m, s_red);
    if (f.range == 0) {  // no tap kept in the tile (uniform over the block)
        if (!direct && threadIdx.x == 0) counts[t.blk] = 0;
        return;
    }
    const int end_bit = 32 - __clz(f.range);

    // Sort the tile's taps by key; ties keep the item order pixel*8 + code.
    unsigned keys[CODES];
    unsigned short vals[CODES];
#pragma unroll
    for (int k = 0; k < CODES; ++k) {
        const int s = k >> 2;
        Tap tp{-1, 0.0f, 0.0f};
        if ((kept >> k) & 1u) tp.texel = s_texel[threadIdx.x * CODES + k];
        keys[k] = tap_key(sl[s], tp, k, f);
        vals[k] = static_cast<unsigned short>(threadIdx.x * CODES + k);
    }
    Sort(sm.sort).Sort(keys, vals, 0, end_bit);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < CODES; ++j) {
        sm.s.key[threadIdx.x * CODES + j] = keys[j];
        sm.s.item[threadIdx.x * CODES + j] = vals[j];
    }
    __syncthreads();

    // Runs of one key: their heads, numbered by a block scan.
    bool head[CODES];
    int head_texel[CODES];
    int nh = 0;
#pragma unroll
    for (int j = 0; j < CODES; ++j) {
        const int q = threadIdx.x * CODES + j;
        const unsigned prev = q > 0 ? sm.s.key[q - 1] : 0xffffffffu;
        head[j] = keys[j] < f.range && keys[j] != prev;
        head_texel[j] = head[j] ? s_texel[vals[j]] : 0;
        nh += head[j] ? 1 : 0;
        const unsigned next = q + 1 < ITEMS ? sm.s.key[q + 1] : f.range;
        if (keys[j] < f.range && next == f.range) s_nkept = q + 1;
    }
    int incl = nh;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
    }
    if (lane == 31) s_scan[warp] = incl;
    __syncthreads();  // also: every read of the sorted keys and of s_texel by item is done
    int run = 0, nruns = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
        run += w < warp ? s_scan[w] : 0;
        nruns += s_scan[w];
    }
    run += incl - nh;
#pragma unroll
    for (int j = 0; j < CODES; ++j) {
        if (head[j]) {
            sm.s.key[run] = threadIdx.x * CODES + j;  // the run's start
            s_texel[run] = head_texel[j];
            ++run;
        }
    }
    __syncthreads();
    const int nkept = s_nkept;
    if (!direct) {
        if (threadIdx.x == 0) counts[t.blk] = nruns;
        if (nruns > CAP) return;  // the second pass writes this tile
    }

    // One warp per run: its taps' float64 sum in a fixed order.
    for (int r = warp; r < nruns; r += NT / 32) {
        const int lo = static_cast<int>(sm.s.key[r]);
        const int hi = r + 1 < nruns ? static_cast<int>(sm.s.key[r + 1]) : nkept;
        double acc[C];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = 0.0;
        for (int q = lo + lane; q < hi; q += 32) {
            const int item = sm.s.item[q];
            const int p = item / CODES;
            const float lwv = s_lwv[item], uw = s_uw[item];
#pragma unroll
            for (int c = 0; c < C; ++c)
                acc[c] += static_cast<double>(__fmul_rn(__fmul_rn(lwv, s_gc[c][p]), uw));
        }
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = warp_sum(acc[c]);
        if (lane == 0) {
            const long long o = o0 + r;
            texel_out[o] = s_texel[r];
#pragma unroll
            for (int c = 0; c < C; ++c) part_out[o * C + c] = acc[c];
        }
    }
}

bool bad_args(int B, int H, int W, int L, int boundary, int filter) {
    return L < 1 || L > MAX_LEVELS || boundary < 0 || boundary > 2 || filter < 0 || filter > 2 ||
           B <= 0 || H <= 0 || W <= 0;
}

}  // namespace

// u, v, flevel [N], gc [C, N] float32 (N = B*H*W), meta as
// nvdr_texture_fwd. First pass (offsets null): counts [tiles] int32, the
// entries of each tile (one per run of one key of its sort), and, for the
// tiles of at most 64 entries, those entries in the tile's 64 slots of
// texel_s [tiles * 64] int32 and part_s [tiles * 64, C] float64. Second
// pass (offsets [tiles] int64, the exclusive scan of the counts): every
// tile's entries at its offset of texel [E] int32 and partial [E, C]
// float64, moved from the scratch or, past 64, computed again. 1 <= C <= 8.
extern "C" int nvdr_texture_grad_tiles(const float* u, const float* v, const float* flevel,
                                       const float* gc, const int* meta,
                                       const long long* offsets, int* counts, int* texel_s,
                                       double* part_s, int* texel, double* partial, int B,
                                       int H, int W, int C, int L, int per_image, int boundary,
                                       int filter, void* stream) {
    if (bad_args(B, H, W, L, boundary, filter)) return static_cast<int>(cudaErrorInvalidValue);
    const Levels lv = levels_from_meta(meta, L);
    const int N = B * H * W;
    const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
    const int n_tiles = static_cast<int>(grid.x * grid.y * grid.z);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NVDR_TEX_TILES_CASE(n)                                                                \
    case n:                                                                                   \
        if (offsets == nullptr) {                                                             \
            tex_grad_tiles<n><<<grid, NT, 0, s>>>(u, v, flevel, gc, N, H, W, L, filter,       \
                                                  boundary, per_image, lv, nullptr, counts,   \
                                                  texel_s, part_s);                           \
        } else {                                                                              \
            const int err = nvdr_segment_compact(counts, offsets, n_tiles, CAP, n, texel_s,   \
                                                 part_s, texel, partial, s);                  \
            if (err != 0) return err;                                                         \
            tex_grad_tiles<n><<<grid, NT, 0, s>>>(u, v, flevel, gc, N, H, W, L, filter,       \
                                                  boundary, per_image, lv, offsets, counts,   \
                                                  texel, partial);                            \
        }                                                                                     \
        break;
    switch (C) {
        NVDR_TEX_TILES_CASE(1)
        NVDR_TEX_TILES_CASE(2)
        NVDR_TEX_TILES_CASE(3)
        NVDR_TEX_TILES_CASE(4)
        NVDR_TEX_TILES_CASE(5)
        NVDR_TEX_TILES_CASE(6)
        NVDR_TEX_TILES_CASE(7)
        NVDR_TEX_TILES_CASE(8)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef NVDR_TEX_TILES_CASE
    return static_cast<int>(cudaGetLastError());
}
