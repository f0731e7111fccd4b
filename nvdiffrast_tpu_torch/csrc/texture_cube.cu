// Cube-map sampler, forward and backward, and the cube texture gradient:
// seamless bilinear and trilinear sampling of a flat-packed 6-face mip
// pyramid, deterministic.
//
// Replaces: nvdiffrast_tpu/ops/texture_pallas.py, _call_cube (B12; kernel
// body _build_cube_kernel, with _face_dir_2d, _faceid_project_2d,
// _wrap_corner_2d and cube_corner_setup) in its modes "fwd" (cube_fwd)
// and "bwd" (cube_tiles), for the filters linear, linear-mipmap-nearest
// and linear-mipmap-linear; and the texture gradient of its vjp
// (_sample_cube_bwd: every corner's texel and effective weight, summed by
// scatter.py's _scatter_pallas), which cube_tiles pre-reduces per tile.
//
// The pyramid is one texel-major buffer [n_texels, C]: level l's
// [D, 6, w, w] block starts at texel off[l], so the texel of (tz, face,
// iy, ix) is off + ((tz * 6 + face) * w + iy) * w + ix. The TPU kernel
// splits the levels between VMEM and HBM and gathers big levels through
// double-buffered windows (_split_levels, _gather_big); here the whole
// pyramid stays in device memory and neighbouring pixels' texels come
// from L1 and L2.
//
// Both kernels run one block per 16x16 screen tile and image, one thread
// per pixel p = (b * H + y) * W + x, so a block's corner gathers fall on a
// small patch of texels. Per pixel: the level pair (l0, l1) and blend
// weight (level_weights); for l0 and, where it differs, l1: the four
// corners of (s, t) on the level's face, each wrapped to the neighbour
// face through the cube geometry when it falls off the face (a texel
// centre is turned into a direction, which selects a face and projects
// back; the index rounds half to even, as jnp.round), a diagonal overflow
// at a cube corner marking the corner missing; the corner gathers of C
// floats; a missing corner replaced by the mean of the valid ones; and
//   fwd: out += wgt * (((w00*q00 + w10*q10) + w01*q01) + w11*q11),
//   bwd: gs += (wgt * sum_c dy_c dqu_c) * w_l, gt the same with dqv,
//        gfl += (on1 - on0) * sum_c dy_c val_c,
// levels in ascending order, as the reference's level loop. A pixel whose
// direction is invalid (finite == 0) gets zeros.
//
// The texture gradient (cube_tiles with counts given). A pixel has up to
// 8 taps, code (slot * 4 + corner) for slot 0 (level l0, weight 1 - frac,
// or 1 without the linear mip filter) and slot 1 (l1, frac): a tap adds
// dy_c * ((w_eff * fin) * lw) to its texel, with the average-of-3 rule
// folded into the corner's effective weight,
//   w_eff_j = w_j ok_j + ok_j / n_ok * sum_i w_i (1 - ok_i),
// in float32 in the reference's order (texture_cube_cuda.cube_grad_entries).
// Taps of invalid pixels and taps of weight 0 are left out: they add
// exactly +0 to a sum that starts at +0. A 2048^2 frame has 8N = 33.5 M
// taps; summing them all through one global reduction costs far more than
// the sums, but neighbouring pixels tap neighbouring texels, so the taps
// are pre-reduced where they are made:
//   tiles   each block sorts its tile's 2,048 (key, pixel*8 + code) pairs
//           in shared memory (segment_sum.cuh BlockRuns: stable radix sort
//           over the bits of the tile's key range), the key a kept tap's
//           texel less the tile's smallest, and sums each run of equal
//           keys in float64, in pieces of 64 sorted positions, one warp a
//           piece (lane l the l-th and (l+32)-th tap, then a fixed
//           butterfly of shuffles), a run of several pieces adding their
//           sums in order; in a tile of more than 32 runs, a run of at most
//           8 taps goes to one thread that replays the butterfly (the same
//           bits; segment_sum.cuh sum_runs, shared with scatter_rows.cu):
//           one (texel, tile) partial a run.
//           A tile near a seam or a cube corner taps 2-3 faces, and one
//           across a level change two levels' blocks, so its key can need
//           ~21 bits (six sort passes) where a key by (slot, level, face)
//           and the box of rows and columns each group spans would need
//           ~9; measured on the H100 at 2048^2 (1.85 M partials), that key
//           (the boxes' shared atomics, scan and decoding) was 5-7 %
//           slower in all than the texel's extra passes. The block writes
//           its count and, up to cap of them, the partials to its slots of
//           a scratch (cap 0: count only);
//   (the wrapper scans the counts and reads the total back to the host
//           once, to allocate the partials: the one host sync)
//   compact (segment_sum.cu) moves each tile's partials from its scratch
//           slots to its scan offset, and the tiles kernel runs again for
//           the tiles of more than cap partials, writing there directly
//           (the others return at once; the uv part does not run again);
//   (a stable sort of the partials' texels), segment starts
//           (raster_bin.cu) and sums (segment_sum.cu): each texel's
//           partials added in float64 in sorted order and rounded once.
// No float atomics: the same inputs give the same bits on every run; the
// plain twin (cube_tile_partials_plain, with segments.run_sums) gives the
// partials bit for bit, and the result is within 1 float32 ulp of a
// float64 sum of the same taps. With the uv gradient asked for too, the
// first pass computes both, one pixel read for both (the corners are set
// up again for the taps: held across the uv part they cost registers).
//
// Bound on the H100: device-memory traffic of the pixel streams (s, t,
// flevel, finite, face, tz read, C floats written, plus C cotangents read
// in the backward), and for the texture gradient the partials (4 + 8C
// bytes each) written, moved, sorted and read back and the [n_texels, C]
// output; the corner gathers (8 x C per pixel) hit L1/L2 and the seam
// wrap is ~60 float operations a corner.
//
// Rounding: built with -fmad=false; divisions are IEEE (no fast math);
// every expression keeps the reference's operation order, so the plain
// twins (ops/texture_cube_cuda.py sample_cube_plain, cube_bwd_plain,
// cube_tile_partials_plain) agree to the last bit.
#include <climits>

#include <cuda_runtime.h>

#include "segment_sum.cuh"
#include "texture_corner.cuh"

namespace {

using namespace nvdr_tex;

constexpr int TILE = 16;                    // screen tile edge (texture_cube_cuda.CUBE_TILE)
constexpr int NT = TILE * TILE;             // threads a block, one pixel each
constexpr int CODES = 8;                    // taps a pixel: (slot, corner)
using Runs = nvdr_seg::BlockRuns<NT, CODES>;

// Texel (s, t) on `face` -> direction (_face_dir_2d).
__device__ __forceinline__ void face_dir(int face, float s, float t, float& x, float& y,
                                         float& z) {
    const float du = 2.0f * (s - 0.5f);
    const float dv = 2.0f * (t - 0.5f);
    x = face == 0 ? 1.0f : (face == 1 ? -1.0f : (face == 5 ? -du : du));
    y = face == 2 ? 1.0f : (face == 3 ? -1.0f : -dv);
    z = face == 0 ? -du
                  : (face == 1 ? du
                               : (face == 2 ? dv : (face == 3 ? -dv : (face == 4 ? 1.0f : -1.0f))));
}

// Direction -> (face, s, t), unclipped (_faceid_project_2d). The
// directions here come from texel centres, so they are finite.
__device__ __forceinline__ void faceid_project(float x, float y, float z, int& face, float& s,
                                               float& t) {
    const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
    const bool z_major = az > fmaxf(ax, ay);
    const bool y_major = !z_major && (ay > ax);
    const bool x_major = !(z_major || y_major);
    const float c = z_major ? z : (y_major ? y : x);
    face = (z_major ? 4 : (y_major ? 2 : 0)) + (c < 0.0f ? 1 : 0);
    const float u_in = x_major ? z : x;
    const float v_in = y_major ? z : y;
    const float m = 0.5f / (fabsf(c) > 0.0f ? fabsf(c) : 1.0f);
    const float m0 = (face == 0 || face == 5) ? -m : m;
    const float m1 = face == 2 ? m : -m;
    s = u_in * m0 + 0.5f;
    t = v_in * m1 + 0.5f;
}

// A corner (ix, iy) of `face` that may lie one texel outside it ->
// (row face*w + iy, column, validity) (_wrap_corner_2d).
__device__ __forceinline__ void wrap_corner(int face, int ix, int iy, int w, int& row, int& col,
                                            float& ok) {
    const bool ix_out = ix < 0 || ix >= w;
    const bool iy_out = iy < 0 || iy >= w;
    ok = (ix_out && iy_out) ? 0.0f : 1.0f;
    if (!(ix_out || iy_out)) {
        row = face * w + iy;
        col = ix;
        return;
    }
    const float wf = static_cast<float>(w);
    const float s = (static_cast<float>(ix) + 0.5f) / wf;
    const float t = (static_cast<float>(iy) + 0.5f) / wf;
    float x, y, z, s2, t2;
    int nface;
    face_dir(face, s, t, x, y, z);
    faceid_project(x, y, z, nface, s2, t2);
    const int nix = clampi(static_cast<int>(rintf(s2 * wf - 0.5f)), 0, w - 1);
    const int niy = clampi(static_cast<int>(rintf(t2 * wf - 0.5f)), 0, w - 1);
    row = nface * w + niy;
    col = nix;
}

// Corners of one level (cube_corner_setup): texel ids relative to the
// level's texture block, validity, fractions and weights (no validity).
struct CubeCorners {
    int idx[4];
    float ok[4];
    float fu, fv;
    float w[4];
};

__device__ __forceinline__ CubeCorners cube_corners(float s, float t, int face, int wl) {
    const float w = static_cast<float>(wl);
    const float u = s * w - 0.5f;
    const float v = t * w - 0.5f;
    const int iu0 = static_cast<int>(floorf(u));
    const int iv0 = static_cast<int>(floorf(v));
    CubeCorners k;
    k.fu = u - static_cast<float>(iu0);
    k.fv = v - static_cast<float>(iv0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        int row, col;
        wrap_corner(face, iu0 + (j & 1), iv0 + (j >> 1), wl, row, col, k.ok[j]);
        k.idx[j] = row * wl + col;
    }
    const float gu = 1.0f - k.fu;
    const float gv = 1.0f - k.fv;
    k.w[0] = gu * gv;
    k.w[1] = k.fu * gv;
    k.w[2] = gu * k.fv;
    k.w[3] = k.fu * k.fv;
    return k;
}

// The four corner texels of every channel, a missing one replaced by the
// mean of the valid ones (the average-of-3 rule).
template <int C>
__device__ __forceinline__ void filled_corners(const float* __restrict__ tex, int base,
                                               const CubeCorners& k, float (&qq)[4][C]) {
    const float n_ok = fmaxf(((k.ok[0] + k.ok[1]) + k.ok[2]) + k.ok[3], 1.0f);
#pragma unroll
    for (int c = 0; c < C; ++c) {
        float q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) q[j] = __ldg(tex + static_cast<size_t>(base + k.idx[j]) * C + c);
        const float avg =
            (((k.ok[0] * q[0] + k.ok[1] * q[1]) + k.ok[2] * q[2]) + k.ok[3] * q[3]) / n_ok;
#pragma unroll
        for (int j = 0; j < 4; ++j) qq[j][c] = k.ok[j] > 0.0f ? q[j] : avg;
    }
}

// The block's tile and this thread's pixel.
struct TilePix {
    int blk, p;
    bool in_image;
};

__device__ __forceinline__ TilePix tile_pixel(int H, int W) {
    TilePix t;
    const int b = blockIdx.z;
    const int x = blockIdx.x * TILE + threadIdx.x % TILE;
    const int y = blockIdx.y * TILE + threadIdx.x / TILE;
    t.blk = (b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    t.in_image = x < W && y < H;
    t.p = (b * H + y) * W + x;
    return t;
}

// Five blocks an SM: at most 51 registers a thread (measured on the H100
// at C = 3: 5 % faster than the compiler's 53 registers at four blocks,
// six blocks 9 % slower).
template <int C>
__global__ void __launch_bounds__(NT, 5)
cube_fwd(const float* __restrict__ tex, const float* __restrict__ s, const float* __restrict__ t,
         const float* __restrict__ flevel, const int* __restrict__ finite,
         const int* __restrict__ face, const int* __restrict__ tz, float* __restrict__ out,
         int N, int H, int W, int L, int filter, Levels lv) {
    const TilePix tp = tile_pixel(H, W);
    if (!tp.in_image) return;
    const int p = tp.p;
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.0f;
    if (finite[p] != 0) {
        const float sp = s[p], tq = t[p];
        const int fp = face[p], zp = tz[p];
        int l0, l1;
        float frac;
        level_weights(filter != LINEAR ? flevel[p] : 0.0f, L, filter, l0, l1, frac);
        for (int j = 0; j < 2; ++j) {
            const int lev = j == 0 ? l0 : l1;
            if (j == 1 && l1 == l0) break;
            const bool on0 = lev == l0, on1 = lev == l1;
            const float wgt = (on0 ? 1.0f - frac : 0.0f) + (on1 ? frac : 0.0f);
            const int wl = lv.w[lev];
            const CubeCorners k = cube_corners(sp, tq, fp, wl);
            float qq[4][C];
            filled_corners<C>(tex, lv.off[lev] + zp * (6 * wl * wl), k, qq);
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const float val = ((k.w[0] * qq[0][c] + k.w[1] * qq[1][c]) + k.w[2] * qq[2][c]) +
                                  k.w[3] * qq[3][c];
                acc[c] = acc[c] + wgt * val;
            }
        }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) out[static_cast<size_t>(c) * N + p] = acc[c];
}

// Shared memory of the tiles pass (dynamic: more than 48 KB).
template <int C>
struct TileSmem {
    Runs::Storage runs;
    float wt[NT * CODES];                  // a tap's weight (w_eff * fin) * lw, by item
    float dy[C][NT];                       // the cotangent of the tile's pixels
    double ps[Runs::SLOTS][C];             // the pieces' sums of multi-piece runs
    int red[2 * NT / 32];
};

// The backward tiles pass. First pass (offsets null): with uv_out given,
// (gs, gt, gfl) of every pixel; with TEX (counts given), the tile's
// partial count, and its partials in its cap scratch slots when they fit.
// Second pass: only the tiles of more than cap partials, at their
// offsets. Without TEX the pass is the uv part alone: no shared memory,
// fewer registers.
template <int C, bool TEX>
__global__ void __launch_bounds__(NT)
cube_tiles(const float* __restrict__ tex, const float* __restrict__ s,
           const float* __restrict__ t, const float* __restrict__ flevel,
           const int* __restrict__ finite, const int* __restrict__ face,
           const int* __restrict__ tz, const float* __restrict__ dy, float* __restrict__ uv_out,
           int N, int H, int W, int L, int filter, Levels lv, int cap,
           const long long* __restrict__ offsets, int* __restrict__ counts,
           int* __restrict__ texel_out, double* __restrict__ part_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    TileSmem<C>& sm = *reinterpret_cast<TileSmem<C>*>(smem_raw);
    const TilePix tp = tile_pixel(H, W);
    const bool direct = offsets != nullptr;
    if (direct && counts[tp.blk] <= cap) return;  // uniform over the block
    const long long o0 = direct ? offsets[tp.blk] : static_cast<long long>(tp.blk) * cap;
    const int p = tp.p;

    // The pixel: its level pair and cotangent.
    const bool valid = tp.in_image && finite[p] != 0;
    int l0 = 0, l1 = 0, zp = 0;
    float frac = 0.0f, sp = 0.0f, tq = 0.0f;
    int fp = 0;
    float g[C];
#pragma unroll
    for (int c = 0; c < C; ++c) g[c] = 0.0f;
    if (valid) {
        sp = s[p];
        tq = t[p];
        fp = face[p];
        zp = tz[p];
        level_weights(filter != LINEAR ? flevel[p] : 0.0f, L, filter, l0, l1, frac);
#pragma unroll
        for (int c = 0; c < C; ++c) g[c] = dy[static_cast<size_t>(c) * N + p];
    }

    if (uv_out != nullptr && tp.in_image) {  // gs, gt, gfl; a level's corners at a time
        float gs = 0.0f, gt = 0.0f, gfl = 0.0f;
        if (valid) {
            for (int j = 0; j < 2; ++j) {
                const int lev = j == 0 ? l0 : l1;
                if (j == 1 && l1 == l0) break;
                const bool on0 = lev == l0, on1 = lev == l1;
                const float wgt = (on0 ? 1.0f - frac : 0.0f) + (on1 ? frac : 0.0f);
                const int wl = lv.w[lev];
                const CubeCorners kk = cube_corners(sp, tq, fp, wl);
                float qq[4][C];
                filled_corners<C>(tex, lv.off[lev] + zp * (6 * wl * wl), kk, qq);
                float gu = 0.0f, gv = 0.0f, gl = 0.0f;
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    const float dqu = (1.0f - kk.fv) * (qq[1][c] - qq[0][c]) +
                                      kk.fv * (qq[3][c] - qq[2][c]);
                    const float dqv = (1.0f - kk.fu) * (qq[2][c] - qq[0][c]) +
                                      kk.fu * (qq[3][c] - qq[1][c]);
                    const float val = ((kk.w[0] * qq[0][c] + kk.w[1] * qq[1][c]) +
                                       kk.w[2] * qq[2][c]) +
                                      kk.w[3] * qq[3][c];
                    gu = gu + g[c] * dqu;
                    gv = gv + g[c] * dqv;
                    gl = gl + g[c] * val;
                }
                const float wf = static_cast<float>(wl);
                gs = gs + wgt * gu * wf;
                gt = gt + wgt * gv * wf;
                gfl = gfl + ((on1 ? 1.0f : 0.0f) - (on0 ? 1.0f : 0.0f)) * gl;
            }
        }
        uv_out[p] = gs;
        uv_out[static_cast<size_t>(N) + p] = gt;
        uv_out[2 * static_cast<size_t>(N) + p] = gfl;
    }
    if (!TEX) return;

    // Both slots' corners (slot 1 of the same level shares slot 0's).
    CubeCorners k[2];
    if (valid) {
        k[0] = cube_corners(sp, tq, fp, lv.w[l0]);
        k[1] = l1 != l0 ? cube_corners(sp, tq, fp, lv.w[l1]) : k[0];
    }

    // The taps: weight by item, texel kept in registers.
    const int nslots = filter == MIP_LINEAR ? 2 : 1;
#pragma unroll
    for (int c = 0; c < C; ++c) sm.dy[c][threadIdx.x] = g[c];
    int texel[CODES];
    int tmin = INT_MAX, tmax = INT_MIN;
#pragma unroll
    for (int code = 0; code < CODES; ++code) {
        const int sl = code >> 2, j = code & 3;
        const CubeCorners& kk = k[sl];
        float wt = 0.0f;
        texel[code] = -1;
        if (valid && sl < nslots) {
            const float lw = filter == MIP_LINEAR ? (sl == 0 ? 1.0f - frac : frac) : 1.0f;
            const float inv_w = ((kk.w[0] * (1.0f - kk.ok[0]) + kk.w[1] * (1.0f - kk.ok[1])) +
                                 kk.w[2] * (1.0f - kk.ok[2])) +
                                kk.w[3] * (1.0f - kk.ok[3]);
            const float n_ok = fmaxf(((kk.ok[0] + kk.ok[1]) + kk.ok[2]) + kk.ok[3], 1.0f);
            // (w_eff * fin) * lw with fin = 1: the same bits as w_eff * lw.
            const float w_eff = kk.w[j] * kk.ok[j] + kk.ok[j] / n_ok * inv_w;
            wt = w_eff * lw;
            if (wt != 0.0f) {
                const int lev = sl == 0 ? l0 : l1;
                const int wl = lv.w[lev];
                texel[code] = lv.off[lev] + zp * (6 * wl * wl) + kk.idx[j];
                tmin = min(tmin, texel[code]);
                tmax = max(tmax, texel[code]);
            }
        }
        sm.wt[threadIdx.x * CODES + code] = wt;
    }
    // The tile's range of kept texels: the keys are texels less its start.
    int nthi = tmax < 0 ? INT_MAX : -tmax;
    nvdr_seg::block_min2<NT>(tmin, nthi, sm.red);
    if (tmin == INT_MAX) {  // no tap kept in the tile (uniform over the block)
        if (!direct && threadIdx.x == 0) counts[tp.blk] = 0;
        return;
    }
    const unsigned range = static_cast<unsigned>(-nthi - tmin) + 1u;
    unsigned keys[CODES];
#pragma unroll
    for (int code = 0; code < CODES; ++code)
        keys[code] = texel[code] >= 0 ? static_cast<unsigned>(texel[code] - tmin) : range;
    const int nruns = Runs::run(sm.runs, keys, range);
    if (!direct) {
        if (threadIdx.x == 0) counts[tp.blk] = nruns;
        if (nruns > cap) return;  // the second pass writes this tile
    }

    // Each run's taps summed in float64 in a fixed order (segment_sum.cuh
    // sum_runs): pieces of PIECE sorted positions, one warp a piece, then
    // the pieces of a run in order; in a tile of many runs (a few taps
    // each, as at about a texel a pixel) a run of at most SHORT taps by
    // one thread, the same bits.
    const int npieces = Runs::pieces(sm.runs, nruns);
    const auto value = [&](int item, int c) { return sm.dy[c][item / CODES] * sm.wt[item]; };
    Runs::sum_runs<C>(sm.runs, nruns, npieces, C, sm.ps, value, part_out + o0 * C, C);
    for (int r = threadIdx.x; r < nruns; r += NT)
        texel_out[o0 + r] = tmin + static_cast<int>(sm.runs.rkey[r]);
}

bool bad_args(int B, int H, int W, int L, int filter) {
    return B <= 0 || H <= 0 || W <= 0 || L < 1 || L > MAX_LEVELS || filter < 0 || filter > 2;
}

dim3 tile_grid(int B, int H, int W) {
    return dim3((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
}

template <int C>
int launch_tiles(const float* tex, const float* s, const float* t, const float* flevel,
                 const int* finite, const int* face, const int* tz, const float* dy,
                 float* uv_out, int B, int H, int W, int L, int filter, const Levels& lv,
                 int cap, const long long* offsets, int* counts, int* texel, double* partial,
                 cudaStream_t st) {
    const dim3 grid = tile_grid(B, H, W);
    if (counts == nullptr) {
        cube_tiles<C, false><<<grid, NT, 0, st>>>(tex, s, t, flevel, finite, face, tz, dy,
                                                  uv_out, B * H * W, H, W, L, filter, lv, cap,
                                                  offsets, counts, texel, partial);
        return static_cast<int>(cudaGetLastError());
    }
    const int smem = static_cast<int>(sizeof(TileSmem<C>));
    const cudaError_t err = cudaFuncSetAttribute(
        cube_tiles<C, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cube_tiles<C, true><<<grid, NT, smem, st>>>(tex, s, t, flevel, finite, face, tz, dy, uv_out,
                                                B * H * W, H, W, L, filter, lv, cap, offsets,
                                                counts, texel, partial);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tex [n_texels, C] texel-major pyramid of [D, 6, w, w, C] levels; s, t,
// flevel [N] float32 (flevel unread for filter 0); finite, face, tz [N]
// int32, N = B*H*W pixels p = (b*H + y)*W + x; out [C, N]. meta: L
// triples (off, w, w) in host memory. filter: 0 linear, 1
// linear-mipmap-nearest, 2 linear-mipmap-linear. 1 <= C <= 8,
// 1 <= L <= 17.
extern "C" int nvdr_texture_cube_fwd(const float* tex, const float* s, const float* t,
                                     const float* flevel, const int* finite, const int* face,
                                     const int* tz, float* out, const int* meta, int B, int H,
                                     int W, int C, int L, int filter, void* stream) {
    if (bad_args(B, H, W, L, filter)) return static_cast<int>(cudaErrorInvalidValue);
    const Levels lv = levels_from_meta(meta, L);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NVDR_CUBE_CASE(n)                                                                   \
    case n:                                                                                 \
        cube_fwd<n><<<tile_grid(B, H, W), NT, 0, st>>>(tex, s, t, flevel, finite, face, tz, \
                                                       out, B * H * W, H, W, L, filter, lv); \
        break;
    switch (C) {
        NVDR_CUBE_CASE(1)
        NVDR_CUBE_CASE(2)
        NVDR_CUBE_CASE(3)
        NVDR_CUBE_CASE(4)
        NVDR_CUBE_CASE(5)
        NVDR_CUBE_CASE(6)
        NVDR_CUBE_CASE(7)
        NVDR_CUBE_CASE(8)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef NVDR_CUBE_CASE
    return static_cast<int>(cudaGetLastError());
}

// The backward tiles pass, inputs as nvdr_texture_cube_fwd with dy [C, N]
// the cotangent of the samples. First pass (offsets null): uv_out [3, N]
// = (gs, gt, gfl) unless null (tex is read only for it); unless counts is
// null, counts [tiles] int32 (tile (b * nty + ty) * ntx + tx of the 16x16
// tiles, one partial a run of its sort) and, for the tiles of at most cap
// partials, those in the tile's cap slots of texel_s [tiles * cap] int32
// and part_s [tiles * cap, C] float64. Second pass (offsets [tiles] int64,
// the exclusive scan of the counts; uv_out null): every tile's partials at
// its offset of texel [E] int32 and partial [E, C] float64, moved from the
// scratch or, past cap, computed again. cap >= 0.
extern "C" int nvdr_texture_cube_bwd(const float* tex, const float* s, const float* t,
                                     const float* flevel, const int* finite, const int* face,
                                     const int* tz, const float* dy, float* uv_out,
                                     const int* meta, const long long* offsets, int* counts,
                                     int* texel_s, double* part_s, int* texel, double* partial,
                                     int cap, int B, int H, int W, int C, int L, int filter,
                                     void* stream) {
    if (bad_args(B, H, W, L, filter) || cap < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (offsets != nullptr && (uv_out != nullptr || counts == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const Levels lv = levels_from_meta(meta, L);
    const dim3 grid = tile_grid(B, H, W);
    const int n_tiles = static_cast<int>(grid.x * grid.y * grid.z);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int* keys = texel_s;
    double* parts = part_s;
    if (offsets != nullptr) {
        if (cap > 0) {
            const int err = nvdr_segment_compact(counts, offsets, n_tiles, cap, C, texel_s,
                                                 part_s, texel, partial, st);
            if (err != 0) return err;
        }
        keys = texel;
        parts = partial;
    }
#define NVDR_CUBE_CASE(n)                                                                    \
    case n:                                                                                  \
        return launch_tiles<n>(tex, s, t, flevel, finite, face, tz, dy, uv_out, B, H, W, L,  \
                               filter, lv, cap, offsets, counts, keys, parts, st);
    switch (C) {
        NVDR_CUBE_CASE(1)
        NVDR_CUBE_CASE(2)
        NVDR_CUBE_CASE(3)
        NVDR_CUBE_CASE(4)
        NVDR_CUBE_CASE(5)
        NVDR_CUBE_CASE(6)
        NVDR_CUBE_CASE(7)
        NVDR_CUBE_CASE(8)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef NVDR_CUBE_CASE
}
