// Gradient scatter of the render pipeline: per-pixel rows -> per-triangle
// rows, deterministic.
//
// Replaces: nvdiffrast_tpu/ops/pipeline_pallas.py, pipeline_grad_scatter,
// with and without the textured chain's da4 terms.
//
// The TPU kernel is a windowed one-hot bf16 hi/lo matmul on the MXU over
// chunks of 8,192 pixels, with a sequential grid carrying the
// accumulator: it leans on neighbouring pixels hitting neighbouring
// triangles. On this card blocks run in no order and float atomics would
// make the gradients change from run to run, so the same coherence is
// used another way: each 16x16 screen tile pre-reduces its own entries by
// triangle row in shared memory, and only those partial sums are sorted.
// A pixel p has up to three entries:
//   item 0, its own pixel: live where rid0[p] is a row and its gs (or
//     da4) column is non-zero (the column's loads issued together);
//   item 1 + d, its AA pair of axis d: live where dd2[d, p] != 0 and
//     rid2[d, p] is a row.
//   tiles   one block per tile and image, one thread per pixel, reads
//           rid0, dd2 and the gs column, and
//           radix-sorts the tile's 768 (row, pixel*3 + item) pairs in
//           shared memory over the bits of the tile's row range
//           (segment_sum.cuh BlockRuns: stable, so a row's entries stay
//           in pixel order). A run of one row is expanded in registers
//           and summed in float64 in pieces of 64 entries, one warp a
//           piece (lane l the l-th and (l+32)-th entry, then a fixed
//           butterfly of shuffles), the own pixels' columns first, then
//           the pairs'; a run of several pieces adds their sums in order:
//             own pixel: the bary outer product bb_k * g_a into columns
//               k*A + a and the 9 raster columns of gs into 3A..3A+8;
//               with da4 (A = 2) bb0*g + c0, bb1*g + c1,
//               (bb2*g - c0) - c1, each in float32 as the reference;
//             AA pair: pair_pos_grad replayed from row r of vtbl (one
//               load a run) with fx, fy from the pixel, into the 9
//               columns 3A+9.. of the partial.
//           A partial is (row, 3A+18 float64 sums). The block writes its
//           count and, up to CAP of them, the partials to its slots of a
//           scratch;
//   (the wrapper scans the counts and reads the total back to the host
//           once, to allocate the partials: the one host sync)
//   compact (segment_sum.cu) moves the partials to their offsets; the
//           tiles kernel runs again for the tiles of more than CAP rows
//           (dense meshes), writing there directly;
//   (a stable sort of the partials' rows), segment starts (raster_bin.cu)
//   sums    (segment_sum.cu) each row's partials in sorted order (row,
//           then tile), a hot row split over a warp, rounded once.
// Same inputs, same bits; no warp walks a whole triangle's pixels.
//
// Bound on the H100: bytes. rid0, dd2 and the gs (and da4) column of
// every pixel, b0, b1 of the live own pixels, rid2, ax of the live pairs
// and a vtbl row a partial, the partials written,
// moved and read once, and the [R, 3A+18] output. The float32 expansion
// (~6A + 60 operations an entry) and 3A+18 float64 adds are far below
// the card's rates.
#include <climits>

#include <cuda_runtime.h>

#include "aa_pair.cuh"
#include "segment_sum.cuh"

namespace {

using nvdr_aa::pair_pos_grad;
using nvdr_seg::warp_sum;

constexpr int TILE = 16;         // screen tile edge (pipeline_bwd_cuda.SCATTER_TILE)
constexpr int NT = TILE * TILE;  // threads a block, one pixel each
constexpr int ITEMS = 3;         // entries a pixel: own, AA axis 0, AA axis 1
constexpr int CAP = 16;          // partials a tile keeps in the scratch (SCATTER_CAP)
using Runs = nvdr_seg::BlockRuns<NT, ITEMS>;

template <int A, bool DA>
__global__ void __launch_bounds__(NT)
grad_scatter_tiles(const int* __restrict__ rid0, const float* __restrict__ gs,
                   const float* __restrict__ dd2, const int* __restrict__ rid2,
                   const float* __restrict__ b0, const float* __restrict__ b1,
                   const float* __restrict__ ax0, const float* __restrict__ ax1,
                   const float* __restrict__ da4, const float* __restrict__ vtbl, int cols,
                   int N, int R, int H, int W, float fxo, float fyo, float pxh, float pyh,
                   const long long* __restrict__ offsets, int* __restrict__ counts,
                   int* __restrict__ row_out, double* __restrict__ part_out) {
    constexpr int K = 3 * A + 9;  // attribute + raster columns
    constexpr int WID = K + 9;    // + the AA position columns
    constexpr int NG = A + 9 + (DA ? 4 : 0);  // gs (and da4) rows of a pixel
    __shared__ Runs::Storage sm;
    __shared__ int s_red[2 * NT / 32];
    __shared__ double s_ps[Runs::SLOTS][WID];  // the pieces' sums of multi-piece runs

    const int b = blockIdx.z;
    const int x0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
    const int blk = (b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    // First pass (offsets null): counts[tile] and, when they fit, the
    // partials in the tile's CAP slots of the scratch. Second pass: only
    // the tiles of more than CAP partials, at their offsets.
    const bool direct = offsets != nullptr;
    if (direct && counts[blk] <= CAP) return;  // uniform over the block
    const long long o0 = direct ? offsets[blk] : static_cast<long long>(blk) * CAP;

    const int x = x0 + threadIdx.x % TILE, y = y0 + threadIdx.x / TILE;
    int row[ITEMS] = {-1, -1, -1};
    if (x < W && y < H) {
        const int p = (b * H + y) * W + x;
        const int r0 = rid0[p];
        if (r0 >= 0 && r0 < R) {  // the column's loads issued together
            float g[NG];
#pragma unroll
            for (int k = 0; k < A + 9; ++k) g[k] = gs[static_cast<size_t>(k) * N + p];
#pragma unroll
            for (int k = A + 9; k < NG; ++k) g[k] = da4[static_cast<size_t>(k - A - 9) * N + p];
            bool live = false;
#pragma unroll
            for (int k = 0; k < NG; ++k) live = live || g[k] != 0.0f;
            if (live) row[0] = r0;
        }
#pragma unroll
        for (int d = 0; d < 2; ++d) {
            if (dd2[static_cast<size_t>(d) * N + p] != 0.0f) {
                const int r = rid2[static_cast<size_t>(d) * N + p];
                if (r >= 0 && r < R) row[1 + d] = r;
            }
        }
    }
    int lo = INT_MAX, nhi = INT_MAX;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
        if (row[j] >= 0) {
            lo = min(lo, row[j]);
            nhi = min(nhi, -row[j]);
        }
    }
    nvdr_seg::block_min2<NT>(lo, nhi, s_red);
    if (lo == INT_MAX) {  // no live entry in the tile (uniform over the block)
        if (!direct && threadIdx.x == 0) counts[blk] = 0;
        return;
    }
    const unsigned range = static_cast<unsigned>(-nhi - lo) + 1u;
    unsigned keys[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) keys[j] = row[j] >= 0 ? static_cast<unsigned>(row[j] - lo) : range;
    const int nruns = Runs::run(sm, keys, range);
    if (!direct) {
        if (threadIdx.x == 0) counts[blk] = nruns;
        if (nruns > CAP) return;  // the second pass writes this tile
    }

    // Each run's entries expanded and summed in float64 in pieces of PIECE
    // (segment_sum.cuh), one warp a piece: first the own pixels' K
    // columns, then the AA pairs' 9 (an entry adds exactly +0 to the other
    // group); then the pieces of a run, in order.
    const int npieces = Runs::pieces(sm, nruns);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int pc = warp; pc < npieces; pc += NT / 32) {
        const int r = sm.prun[pc];
        const int e0 = sm.start[r] + (pc - sm.pfirst[r]) * nvdr_seg::PIECE;
        const int e1 = min(e0 + nvdr_seg::PIECE, sm.start[r + 1]);
        const bool multi = sm.pfirst[r + 1] - sm.pfirst[r] > 1;
        const int rr = lo + static_cast<int>(sm.rkey[r]);
        double* out = multi ? s_ps[sm.mfirst[r] + pc - sm.pfirst[r]] : part_out + (o0 + r) * WID;
        double acc[K];
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] = 0.0;
        for (int q = e0 + lane; q < e1; q += 32) {
            const int item = sm.item[q];
            const int pix = item / ITEMS;
            if (item - pix * ITEMS != 0) continue;
            const int p = (b * H + y0 + pix / TILE) * W + x0 + pix % TILE;
            const float bb0 = b0[p];
            const float bb1 = b1[p];
            const float bb2 = 1.0f - bb0 - bb1;
#pragma unroll
            for (int a = 0; a < A; ++a) {
                const float g = gs[static_cast<size_t>(a) * N + p];
                if constexpr (DA) {  // A == 2: c0_a = da4[a], c1_a = da4[2 + a]
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
        }
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] = warp_sum(acc[k]);
        if (lane == 0) {
#pragma unroll
            for (int k = 0; k < K; ++k) out[k] = acc[k];
        }

        float t9[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) t9[k] = vtbl[static_cast<size_t>(k) * cols + rr];
        double aa[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) aa[k] = 0.0;
        for (int q = e0 + lane; q < e1; q += 32) {
            const int item = sm.item[q];
            const int pix = item / ITEMS, type = item - pix * ITEMS;
            if (type == 0) continue;
            const int xx = x0 + pix % TILE, yy = y0 + pix / TILE;
            const int p = (b * H + yy) * W + xx;
            const float fx = static_cast<float>(xx) + fxo;
            const float fy = static_cast<float>(yy) + fyo;
            float g9[9];
            if (type == 1)
                pair_pos_grad<0>(t9, dd2[p], ax0[p], fx, fy, pxh, pyh, g9);
            else
                pair_pos_grad<1>(t9, dd2[static_cast<size_t>(N) + p], ax1[p], fx, fy, pxh, pyh,
                                 g9);
#pragma unroll
            for (int k = 0; k < 9; ++k) aa[k] += static_cast<double>(g9[k]);
        }
#pragma unroll
        for (int k = 0; k < 9; ++k) aa[k] = warp_sum(aa[k]);
        if (lane == 0) {
#pragma unroll
            for (int k = 0; k < 9; ++k) out[K + k] = aa[k];
            if (!multi) row_out[o0 + r] = rr;
        }
    }
    __syncthreads();
    for (int r = threadIdx.x; r < nruns; r += NT) {  // the multi-piece runs
        const int np = sm.pfirst[r + 1] - sm.pfirst[r];
        if (np < 2) continue;
        const int m = sm.mfirst[r];
        double* out = part_out + (o0 + r) * WID;
        for (int k = 0; k < WID; ++k) {
            double t = s_ps[m][k];
            for (int i = 1; i < np; ++i) t += s_ps[m + i][k];
            out[k] = t;
        }
        row_out[o0 + r] = lo + static_cast<int>(sm.rkey[r]);
    }
}

}  // namespace

// rid0 [N] int32, gs [A+9, N], dd2 [2, N] float32, rid2 [2, N] int32, b0,
// b1, ax0, ax1 [N], da4 [4, N] or null, vtbl [9, cols] float32 (N =
// B*H*W, R rows). First pass (offsets null): counts [tiles] int32 (tile
// (b * nty + ty) * ntx + tx of the 16x16 tiles), and for the tiles of at
// most 16 partials those in the tile's 16 slots of row_s [tiles * 16]
// int32 and part_s [tiles * 16, 3A+18] float64. Second pass (offsets
// [tiles] int64, the exclusive scan of the counts): every tile's
// partials at its offset of row [E] int32 and partial [E, 3A+18]
// float64, moved from the scratch or, past 16, computed again. Columns
// 0..3A+8 of a partial are gt's, 3A+9.. gaa's. 1 <= A <= 8; A == 2 with
// da4.
extern "C" int nvdr_grad_scatter(const int* rid0, const float* gs, const float* dd2,
                                 const int* rid2, const float* b0, const float* b1,
                                 const float* ax0, const float* ax1, const float* da4,
                                 const float* vtbl, int cols, const long long* offsets,
                                 int* counts, int* row_s, double* part_s, int* row,
                                 double* partial, int B, int H, int W, int R, int A, float fxo,
                                 float fyo, float pxh, float pyh, void* stream) {
    if (B <= 0 || H <= 0 || W <= 0 || R <= 0) return static_cast<int>(cudaErrorInvalidValue);
    if (da4 != nullptr && A != 2) return static_cast<int>(cudaErrorInvalidValue);
    const int N = B * H * W;
    const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
    const int n_tiles = static_cast<int>(grid.x * grid.y * grid.z);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int* rows_out = row_s;
    double* parts_out = part_s;
    if (offsets != nullptr) {
        const int err = nvdr_segment_compact(counts, offsets, n_tiles, CAP, 3 * A + 18, row_s,
                                             part_s, row, partial, s);
        if (err != 0) return err;
        rows_out = row;
        parts_out = partial;
    }
#define NVDR_SCATTER_LAUNCH(n, da)                                                           \
    grad_scatter_tiles<n, da><<<grid, NT, 0, s>>>(rid0, gs, dd2, rid2, b0, b1, ax0, ax1, da4, \
                                                  vtbl, cols, N, R, H, W, fxo, fyo, pxh, pyh, \
                                                  offsets, counts, rows_out, parts_out)
    if (da4 != nullptr) {
        NVDR_SCATTER_LAUNCH(2, true);
        return static_cast<int>(cudaGetLastError());
    }
    switch (A) {
        case 1: NVDR_SCATTER_LAUNCH(1, false); break;
        case 2: NVDR_SCATTER_LAUNCH(2, false); break;
        case 3: NVDR_SCATTER_LAUNCH(3, false); break;
        case 4: NVDR_SCATTER_LAUNCH(4, false); break;
        case 5: NVDR_SCATTER_LAUNCH(5, false); break;
        case 6: NVDR_SCATTER_LAUNCH(6, false); break;
        case 7: NVDR_SCATTER_LAUNCH(7, false); break;
        case 8: NVDR_SCATTER_LAUNCH(8, false); break;
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef NVDR_SCATTER_LAUNCH
    return static_cast<int>(cudaGetLastError());
}
