// The second half of the per-tile gradient reductions (texture_grad.cu,
// grad_scatter.cu, scatter_rows.cu): each tile pass writes one float64
// partial sum per (row, tile) it touched; these entry points move the
// partials into place and add them up by row.
//
//   compact  moves each tile's entries from its CAP slots of the first
//            pass's scratch to its offset (the exclusive scan of the
//            tiles' counts); the tiles of more than CAP entries are left
//            to the tile pass's second run, which writes there directly.
//   (the wrapper sorts the entries' int32 rows stably: row-major, then
//            tile, then the tile's order)
//   sums     one thread per RUN consecutive sorted entries sums each
//            row's stretch within them in float64, in sorted order; then
//            one thread per row adds its stretches' sums in ascending
//            order and rounds to float32 once; a row of more than 32
//            stretches takes its whole warp (lane l the stretches l,
//            l+32, ..., then the fixed butterfly). Channels go G at a
//            time, one group per blockIdx.y: each is its own sum.
// Every float64 sum has a fixed order given the inputs (the sort is
// stable; lanes and stretches are fixed partitions of sorted positions),
// so the result is bitwise repeatable. A hot row (a triangle that fills
// the view collects an entry from each of thousands of tiles) costs a
// lane E / (32 RUN) loads, not E.
//
// Bytes: the entries (4 + 8K each) moved once, read once by the sums with
// their sorted position (8), the [rows, K] output written once; K float64
// adds an entry. The bound is bytes.
#include <cuda_runtime.h>

#include "segment_sum.cuh"

namespace {

using nvdr_seg::warp_sum;

constexpr int RUN = 16;   // sorted entries a thread of the stretch pass sums
constexpr int G = 8;      // channels a block of the sum passes handles
constexpr int BLOCK = 256;

// A tile's first count entries are contiguous in the scratch (slots
// blk * cap ...) and at their offset: one block copies them in order.
__global__ void __launch_bounds__(BLOCK)
seg_compact(const int* __restrict__ counts, const long long* __restrict__ offsets, int cap,
            int K, const int* __restrict__ key_s, const double* __restrict__ part_s,
            int* __restrict__ key_out, double* __restrict__ part_out) {
    const int n = counts[blockIdx.x];
    if (n > cap) return;
    const long long src = static_cast<long long>(blockIdx.x) * cap;
    const long long dst = offsets[blockIdx.x];
    for (int i = threadIdx.x; i < n; i += BLOCK) key_out[dst + i] = key_s[src + i];
    const long long m = static_cast<long long>(n) * K;
    for (long long i = threadIdx.x; i < m; i += BLOCK) part_out[dst * K + i] = part_s[src * K + i];
}

// skey [E] the entries' rows, sorted stably, perm [E] int64 their rows
// of part [E, K] -> pp[q] at every q that ends its row's stretch within
// its block of RUN sorted positions: the float64 sum of those entries,
// in sorted order (channels k0 .. k0 + G - 1).
__global__ void __launch_bounds__(BLOCK)
seg_stretches(const int* __restrict__ skey, const long long* __restrict__ perm, long long E,
              const double* __restrict__ part, int K, double* __restrict__ pp) {
    const long long lo = (static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x) * RUN;
    const int k0 = blockIdx.y * G;
    const int kc = min(G, K - k0);
    if (lo >= E) return;
    double acc[G];
#pragma unroll
    for (int c = 0; c < G; ++c) acc[c] = 0.0;
    int cur = skey[lo];
#pragma unroll
    for (int i = 0; i < RUN; ++i) {
        const long long q = lo + i;
        if (q < E) {
            const long long e = perm[q];
#pragma unroll
            for (int c = 0; c < G; ++c)
                if (c < kc) acc[c] += part[e * K + k0 + c];
            const int nxt = (i + 1 < RUN && q + 1 < E) ? skey[q + 1] : -1;
            if (nxt != cur) {
#pragma unroll
                for (int c = 0; c < G; ++c) {
                    if (c < kc) pp[q * K + k0 + c] = acc[c];
                    acc[c] = 0.0;
                }
                cur = nxt;
            }
        }
    }
}

// One thread per row: its stretches' sums (pp at the stretch ends, one
// per RUN block of its sorted entries [starts[t], starts[t+1])), in
// ascending order, rounded to float32 once; 0 for a row without entries.
// A row of more than 32 stretches is summed by its whole warp.
__global__ void __launch_bounds__(BLOCK)
seg_rows(const int* __restrict__ starts, const double* __restrict__ pp, int K,
         float* __restrict__ out, int n_rows) {
    const int t = blockIdx.x * BLOCK + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const int k0 = blockIdx.y * G;
    const int kc = min(G, K - k0);
    long long s = 0, e = 0;
    if (t < n_rows) {
        s = starts[t];
        e = starts[t + 1];
    }
    const long long m0 = s / RUN, m1 = e > s ? (e - 1) / RUN : m0 - 1;
    const bool lng = m1 - m0 + 1 > 32;
    double acc[G];
#pragma unroll
    for (int c = 0; c < G; ++c) acc[c] = 0.0;
    if (!lng) {
        for (long long m = m0; m <= m1; ++m) {
            const long long tail = min(e, (m + 1) * RUN) - 1;
#pragma unroll
            for (int c = 0; c < G; ++c)
                if (c < kc) acc[c] += pp[tail * K + k0 + c];
        }
    }
    unsigned todo = __ballot_sync(0xffffffffu, lng);
    while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const long long ss = __shfl_sync(0xffffffffu, s, src);
        const long long ee = __shfl_sync(0xffffffffu, e, src);
        double part[G];
#pragma unroll
        for (int c = 0; c < G; ++c) part[c] = 0.0;
        for (long long m = ss / RUN + lane; m <= (ee - 1) / RUN; m += 32) {
            const long long tail = min(ee, (m + 1) * RUN) - 1;
#pragma unroll
            for (int c = 0; c < G; ++c)
                if (c < kc) part[c] += pp[tail * K + k0 + c];
        }
#pragma unroll
        for (int c = 0; c < G; ++c) {
            part[c] = warp_sum(part[c]);
            if (lane == src) acc[c] = part[c];
        }
    }
    if (t < n_rows) {
#pragma unroll
        for (int c = 0; c < G; ++c)
            if (c < kc) out[static_cast<size_t>(t) * K + k0 + c] = static_cast<float>(acc[c]);
    }
}

}  // namespace

// The second pass's move: counts [tiles] int32, offsets [tiles] int64
// (their exclusive scan), the first pass's scratch key_s [tiles * cap]
// int32 and part_s [tiles * cap, K] float64 -> key [E] int32 and partial
// [E, K] float64 at the offsets, for every tile of at most cap entries.
extern "C" int nvdr_segment_compact(const int* counts, const long long* offsets, int n_tiles,
                                    int cap, int K, const int* key_s, const double* part_s,
                                    int* key, double* partial, void* stream) {
    if (n_tiles < 0 || cap <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
    if (n_tiles > 0)
        seg_compact<<<n_tiles, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
            counts, offsets, cap, K, key_s, part_s, key, partial);
    return static_cast<int>(cudaGetLastError());
}

// skey [E] the entries' rows, sorted stably, perm [E] int64 their rows of
// partial [E, K] float64, starts [n_rows + 1] int32 (nvdr_segment_starts
// of skey) -> pp [max(E, 1), K] float64 scratch, out [n_rows, K] float32.
extern "C" int nvdr_segment_sums(const int* skey, const long long* perm, long long E,
                                 const int* starts, const double* partial, double* pp,
                                 float* out, int n_rows, int K, void* stream) {
    if (n_rows <= 0) return static_cast<int>(cudaGetLastError());
    if (E < 0 || K <= 0 || K > G * 65535) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned groups = static_cast<unsigned>((K + G - 1) / G);
    const long long runs = (E + RUN - 1) / RUN;
    if (E > 0)
        seg_stretches<<<dim3(static_cast<unsigned>((runs + BLOCK - 1) / BLOCK), groups), BLOCK, 0,
                        s>>>(skey, perm, E, partial, K, pp);
    seg_rows<<<dim3(static_cast<unsigned>((n_rows + BLOCK - 1) / BLOCK), groups), BLOCK, 0, s>>>(
        starts, pp, K, out, n_rows);
    return static_cast<int>(cudaGetLastError());
}
