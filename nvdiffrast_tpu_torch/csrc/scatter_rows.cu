// Deterministic sum of pixel columns into table rows by id:
// out[r, k] = sum over i with ids[i] == r of vals[k, i].
//
// Replaces: nvdiffrast_tpu/ops/scatter.py, _scatter_pallas
// (scatter_add_by_id): the reduction that ends the standalone ops'
// backwards (rasterize to triangle rows, interpolate to attribute rows,
// antialias to triangle rows).
//
// The TPU kernel builds a one-hot [chunk, rows] matrix per pixel chunk
// and multiplies it into a VMEM accumulator on the MXU, with a
// sequential grid carrying the sum. On this card blocks run in no order
// and float atomics would make the sums change from run to run, so the
// reduction is by segment instead, as grad_scatter.cu and
// texture_grad.cu do. The wrapper (scatter.entries, index glue) keeps
// the live columns (an id in [0, R) and a non-zero column: a zero column
// adds exactly nothing to a sum that starts at +0) and stable-sorts them
// by id; row r owns codes[off[r], off[r+1]), split into pieces of PIECE
// entries, numbered first[r] .. first[r+1]-1.
//   Pass 1: one warp per piece. Its lanes walk the piece (lane l takes
//     entries l, l+32, ...) and sum each entry's K values in float64,
//     KC channels at a time; a butterfly of shuffles adds the 32 partial
//     sums in a fixed order into partial[piece].
//   Pass 2: one warp per row sums its pieces' partials the same way and
//     rounds to float32 once.
// The pieces bound every warp's work: a triangle that fills the view is
// one row with millions of entries, which one warp would serialise.
// Same inputs, same bits.
//
// Bound on the H100: device-memory traffic of the sorted codes, each
// live entry's K values (gathered reads) and the [R, K] output; the
// float64 adds are K an entry.
#include <cuda_runtime.h>

#include "segment_sum.cuh"

namespace {

using nvdr_seg::warp_sum;

constexpr int PIECE = 256;  // entries a piece (scatter.PIECE)
constexpr int KC = 8;       // channels summed per walk of a piece
constexpr int WARPS = 4;
constexpr int BLOCK = 32 * WARPS;

__global__ void __launch_bounds__(BLOCK)
rows_pieces(const int* __restrict__ codes, const int* __restrict__ off,
            const int* __restrict__ first, const float* __restrict__ vals,
            double* __restrict__ partial, int R, int n_pieces, int N, int K) {
    const int piece = blockIdx.x * WARPS + threadIdx.x / 32;  // uniform over the warp
    const int lane = threadIdx.x % 32;
    if (piece >= n_pieces) return;
    const int lo = nvdr_seg::piece_owner(first, R, piece);  // the row
    const int e0 = off[lo] + (piece - first[lo]) * PIECE;
    const int e1 = min(e0 + PIECE, off[lo + 1]);
    for (int k0 = 0; k0 < K; k0 += KC) {
        double acc[KC];
#pragma unroll
        for (int j = 0; j < KC; ++j) acc[j] = 0.0;
        for (int e = e0 + lane; e < e1; e += 32) {
            const int i = codes[e];
#pragma unroll
            for (int j = 0; j < KC; ++j)
                if (k0 + j < K) acc[j] += static_cast<double>(vals[static_cast<size_t>(k0 + j) * N + i]);
        }
#pragma unroll
        for (int j = 0; j < KC; ++j) {
            const double t = warp_sum(acc[j]);
            if (lane == 0 && k0 + j < K) partial[static_cast<size_t>(piece) * K + k0 + j] = t;
        }
    }
}

__global__ void __launch_bounds__(BLOCK)
rows_sum(const int* __restrict__ first, const double* __restrict__ partial,
         float* __restrict__ out, int R, int K) {
    const int r = blockIdx.x * WARPS + threadIdx.x / 32;  // uniform over the warp
    const int lane = threadIdx.x % 32;
    if (r >= R) return;
    const int k1 = first[r + 1];
    for (int k0 = 0; k0 < K; k0 += KC) {
        double acc[KC];
#pragma unroll
        for (int j = 0; j < KC; ++j) acc[j] = 0.0;
        for (int k = first[r] + lane; k < k1; k += 32) {
#pragma unroll
            for (int j = 0; j < KC; ++j)
                if (k0 + j < K) acc[j] += partial[static_cast<size_t>(k) * K + k0 + j];
        }
#pragma unroll
        for (int j = 0; j < KC; ++j) {
            const double s = warp_sum(acc[j]);
            if (lane == 0 && k0 + j < K) out[static_cast<size_t>(r) * K + k0 + j] = static_cast<float>(s);
        }
    }
}

}  // namespace

// codes [M] int32 (live columns sorted by id), off [R+1] their row
// segments, first [R+1] the first piece of each row (n_pieces in all);
// vals [K, N] float32 -> partial [max(n_pieces, 1), K] float64 scratch,
// out [R, K] float32.
extern "C" int nvdr_scatter_rows(const int* codes, const int* off, const int* first,
                                 const float* vals, double* partial, float* out, int R,
                                 int n_pieces, int N, int K, void* stream) {
    if (R <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
    if (n_pieces < 0 || N < 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_pieces > 0)
        rows_pieces<<<(n_pieces + WARPS - 1) / WARPS, BLOCK, 0, s>>>(codes, off, first, vals,
                                                                    partial, R, n_pieces, N, K);
    rows_sum<<<(R + WARPS - 1) / WARPS, BLOCK, 0, s>>>(first, partial, out, R, K);
    return static_cast<int>(cudaGetLastError());
}
