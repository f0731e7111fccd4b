// Pieces of the deterministic segmented sums (grad_scatter.cu,
// texture_grad.cu, scatter_rows.cu): entries sorted by their row, each
// row's entries summed by one warp in float64 in a fixed order, long rows
// split into pieces whose partial sums a second pass adds. No float
// atomics: the same inputs give the same bits on every run.
#pragma once

#include <cuda_runtime.h>

namespace nvdr_seg {

// The 32 lanes' partial sums added by a butterfly of shuffles, in a fixed
// order; every lane ends with the total.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// The row owning piece `piece`: the last r in [0, n) with first[r] <= piece
// (first[r] is row r's first piece, ascending, first[0] = 0).
__device__ __forceinline__ int piece_owner(const int* __restrict__ first, int n, int piece) {
    int lo = 0, hi = n;
    while (hi - lo > 1) {
        const int mid = (lo + hi) / 2;
        if (first[mid] <= piece) lo = mid; else hi = mid;
    }
    return lo;
}

}  // namespace nvdr_seg
