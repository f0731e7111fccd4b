// Deterministic sum of pixel columns into table rows by id:
// out[r, k] = sum over i with ids[i] == r of vals[k, i].
//
// Replaces: nvdiffrast_tpu/ops/scatter.py, _scatter_pallas
// (scatter_add_by_id): the reduction that ends the standalone ops'
// backwards (rasterize to triangle rows, interpolate to attribute rows,
// antialias to triangle rows) and sums the cube and `nearest` texture
// taps into texels.
//
// The TPU kernel builds a one-hot [chunk, rows] matrix per pixel chunk
// over only the 128-row windows the chunk touches and multiplies it into
// a VMEM accumulator on the MXU, with a sequential grid carrying the sum.
// On this card blocks run in no order and float atomics would make the
// sums change from run to run. The triangle-row callers' columns are
// coherent (pixel order; the AA pairs' axis 0, then axis 1), so each chunk
// of CHUNK consecutive columns pre-reduces its own columns by id in shared
// memory, as grad_scatter.cu does per tile, and only those partial sums are
// sorted. The cube taps (corner after corner in pixel order) are not: the
// mip level puts about one texel under a pixel, so a chunk's taps mostly
// hit distinct texels (on the bench sphere at 2048^2, 12.4 M live taps make
// 8.8 M partials) and most chunks pass CAP:
//   chunks  one block per chunk, one thread per column, reads the id and,
//           for an id in [0, R), its first KC values (kept in shared
//           memory for the walk; the rest up to a non-zero one, if none
//           is) (a live column has an id in [0, R) and a non-zero column:
//           a zero column adds exactly nothing to a sum that starts at
//           +0; other ids are dropped), and radix-sorts the chunk's
//           (id, column) pairs in shared memory over the bits of its id
//           range (segment_sum.cuh BlockRuns, stable). A run of one id
//           is summed in float64 (KC channels a walk: all of them in one
//           walk when K <= KC) in pieces of 64 columns, one warp a piece
//           (lane l the l-th and (l+32)-th, then a fixed butterfly of
//           shuffles), a run of several pieces adding their sums in order,
//           a partial (id, K float64 sums); in a chunk of more than 32
//           runs (incoherent ids: the cube taps, random ids) a run of at
//           most 8 columns is summed by one thread that replays the
//           butterfly, the same bits. The block writes its count
//           and, up to CAP of them, the partials to its slots of a
//           scratch;
//   (the wrapper scans the counts and reads the total back to the host
//           once, to allocate the partials: the one host sync)
//   compact (segment_sum.cu) moves them to their offsets; the chunks
//           kernel runs again for the chunks of more than CAP ids
//           (incoherent ids), writing there directly;
//   (a stable sort of the partials' ids), segment starts (raster_bin.cu)
//   sums    (segment_sum.cu) each id's partials in sorted order (id, then
//           chunk), a hot id split over a warp, rounded once.
// A triangle that fills the view is one id with an entry in each of
// thousands of chunks: its sum is spread over a warp, not run in series.
// Same inputs, same bits.
//
// Bound on the H100: bytes. The ids, the values of the columns read
// (live ones; all K of an in-range zero column), the partials written,
// moved and read once, and the [R, K] output; K float64 adds a live
// column.
#include <climits>

#include <cuda_runtime.h>

#include "segment_sum.cuh"

namespace {

using nvdr_seg::warp_sum;

constexpr int CHUNK = 256;  // columns a chunk, one thread each (scatter.CHUNK)
constexpr int CAP = 32;     // partials a chunk keeps in the scratch (scatter.CAP)
constexpr int KC = 16;      // channels summed per walk of a run
constexpr int SHORT = 8;    // a run of at most SHORT columns is summed by one thread
constexpr int MANY = 32;    // ... in a chunk of more than MANY runs (ids that barely reduce)
using Runs = nvdr_seg::BlockRuns<CHUNK, 1>;

__global__ void __launch_bounds__(CHUNK)
scatter_chunks(const int* __restrict__ ids, const float* __restrict__ vals, int N, int K, int R,
               const long long* __restrict__ offsets, int* __restrict__ counts,
               int* __restrict__ id_out, double* __restrict__ part_out) {
    __shared__ Runs::Storage sm;
    __shared__ float s_val[KC][CHUNK];  // a live column's first KC values
    __shared__ int s_red[2 * CHUNK / 32];
    __shared__ double s_ps[Runs::SLOTS][KC];  // the pieces' sums of multi-piece runs

    const int blk = blockIdx.x;
    // First pass (offsets null): counts[chunk] and, when they fit, the
    // partials in the chunk's CAP slots of the scratch. Second pass: only
    // the chunks of more than CAP partials, at their offsets.
    const bool direct = offsets != nullptr;
    if (direct && counts[blk] <= CAP) return;  // uniform over the block
    const long long o0 = direct ? offsets[blk] : static_cast<long long>(blk) * CAP;

    const int c0 = blk * CHUNK;
    const int i = c0 + threadIdx.x;
    int id = -1;
    if (i < N) {
        const int v = ids[i];
        if (v >= 0 && v < R) {  // the first KC values loaded together
            float x[KC];
#pragma unroll
            for (int j = 0; j < KC; ++j)
                x[j] = j < K ? vals[static_cast<size_t>(j) * N + i] : 0.0f;
            bool live = false;
#pragma unroll
            for (int j = 0; j < KC; ++j) live = live || x[j] != 0.0f;
            for (int k = KC; k < K && !live; ++k)
                live = vals[static_cast<size_t>(k) * N + i] != 0.0f;
            if (live) {  // kept for the walk
                id = v;
#pragma unroll
                for (int j = 0; j < KC; ++j) s_val[j][threadIdx.x] = x[j];
            }
        }
    }
    int lo = id >= 0 ? id : INT_MAX, nhi = id >= 0 ? -id : INT_MAX;
    nvdr_seg::block_min2<CHUNK>(lo, nhi, s_red);
    if (lo == INT_MAX) {  // no live column in the chunk (uniform over the block)
        if (!direct && threadIdx.x == 0) counts[blk] = 0;
        return;
    }
    const unsigned range = static_cast<unsigned>(-nhi - lo) + 1u;
    unsigned key[1] = {id >= 0 ? static_cast<unsigned>(id - lo) : range};
    const int nruns = Runs::run(sm, key, range);
    if (!direct) {
        if (threadIdx.x == 0) counts[blk] = nruns;
        if (nruns > CAP) return;  // the second pass writes this chunk
    }

    // Each run's float64 sum in a fixed order: pieces of PIECE columns,
    // one warp a piece (segment_sum.cuh), then the pieces of a run in
    // order; KC channels at a time.
    const int npieces = Runs::pieces(sm, nruns);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    // Few runs (coherent ids): every run goes to the warps, in parallel.
    // Many: most are short, and a warp a lone column would spend 5
    // shuffles a channel; those go to one thread each (uniform per block).
    const int short_max = nruns > MANY ? SHORT : 0;
    for (int k0 = 0; k0 < K; k0 += KC) {
        const int nc = min(KC, K - k0);
        if (k0 > 0) __syncthreads();  // the slots' last readers are done
        for (int pc = warp; pc < npieces; pc += CHUNK / 32) {
            const int r = sm.prun[pc];
            if (sm.start[r + 1] - sm.start[r] <= short_max) continue;  // a thread's, below
            const int e0 = sm.start[r] + (pc - sm.pfirst[r]) * nvdr_seg::PIECE;
            const int e1 = min(e0 + nvdr_seg::PIECE, sm.start[r + 1]);
            const bool multi = sm.pfirst[r + 1] - sm.pfirst[r] > 1;
            double acc[KC];
#pragma unroll
            for (int j = 0; j < KC; ++j) acc[j] = 0.0;
            for (int q = e0 + lane; q < e1; q += 32) {
                const int item = sm.item[q];
#pragma unroll
                for (int j = 0; j < KC; ++j)
                    if (j < nc)
                        acc[j] += static_cast<double>(
                            k0 == 0 ? s_val[j][item]
                                    : vals[static_cast<size_t>(k0 + j) * N + c0 + item]);
            }
#pragma unroll
            for (int j = 0; j < KC; ++j)
                if (j < nc) acc[j] = warp_sum(acc[j]);
            if (lane == 0) {
                double* out = multi ? s_ps[sm.mfirst[r] + pc - sm.pfirst[r]]
                                    : part_out + (o0 + r) * K + k0;
#pragma unroll
                for (int j = 0; j < KC; ++j)
                    if (j < nc) out[j] = acc[j];
                if (!multi && k0 == 0) id_out[o0 + r] = lo + static_cast<int>(sm.rkey[r]);
            }
        }
        __syncthreads();
        for (int r = threadIdx.x; r < nruns; r += CHUNK) {  // short and multi-piece runs
            const int s0 = sm.start[r], n = sm.start[r + 1] - s0;
            if (n <= short_max) {
                // The warp's sum of a run of n <= SHORT columns, by one
                // thread: lane q < n holds +0 + value q, the lanes past
                // SHORT hold +0 (the butterfly's first steps add +0 to
                // lanes that already start at +0), then the last steps of
                // the butterfly as lane 0 sees them. The same bits as a
                // warp, without 5 shuffles per channel for a lone column.
                for (int j = 0; j < nc; ++j) {
                    double a[SHORT];
#pragma unroll
                    for (int q = 0; q < SHORT; ++q) {
                        const int item = q < n ? sm.item[s0 + q] : 0;
                        const size_t col = static_cast<size_t>(k0 + j) * N + c0;
                        a[q] = q < n ? 0.0 + static_cast<double>(k0 == 0 ? s_val[j][item]
                                                                         : vals[col + item])
                                     : 0.0;
                    }
#pragma unroll
                    for (int o = SHORT / 2; o > 0; o >>= 1)
#pragma unroll
                        for (int q = 0; q < o; ++q) a[q] += a[q + o];
                    part_out[(o0 + r) * K + k0 + j] = a[0];
                }
                if (k0 == 0) id_out[o0 + r] = lo + static_cast<int>(sm.rkey[r]);
                continue;
            }
            const int np = sm.pfirst[r + 1] - sm.pfirst[r];
            if (np < 2) continue;
            const int m = sm.mfirst[r];
            for (int j = 0; j < nc; ++j) {
                double t = s_ps[m][j];
                for (int i = 1; i < np; ++i) t += s_ps[m + i][j];
                part_out[(o0 + r) * K + k0 + j] = t;
            }
            if (k0 == 0) id_out[o0 + r] = lo + static_cast<int>(sm.rkey[r]);
        }
    }
}

}  // namespace

// ids [N] int32, vals [K, N] float32. First pass (offsets null): counts
// [chunks] int32 (chunk c = columns [256c, 256c + 256)), and for the
// chunks of at most 32 partials those in the chunk's 32 slots of id_s
// [chunks * 32] int32 and part_s [chunks * 32, K] float64. Second pass
// (offsets [chunks] int64, the exclusive scan of the counts): every
// chunk's partials at its offset of id [E] int32 and partial [E, K]
// float64, moved from the scratch or, past 32, computed again.
extern "C" int nvdr_scatter_rows(const int* ids, const float* vals, const long long* offsets,
                                 int* counts, int* id_s, double* part_s, int* id, double* partial,
                                 int N, int K, int R, void* stream) {
    if (N <= 0 || K <= 0 || R <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int n_chunks = (N + CHUNK - 1) / CHUNK;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (offsets == nullptr) {
        scatter_chunks<<<n_chunks, CHUNK, 0, s>>>(ids, vals, N, K, R, nullptr, counts, id_s,
                                                  part_s);
        return static_cast<int>(cudaGetLastError());
    }
    const int err =
        nvdr_segment_compact(counts, offsets, n_chunks, CAP, K, id_s, part_s, id, partial, s);
    if (err != 0) return err;
    scatter_chunks<<<n_chunks, CHUNK, 0, s>>>(ids, vals, N, K, R, offsets, counts, id, partial);
    return static_cast<int>(cudaGetLastError());
}
