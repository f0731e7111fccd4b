// Pieces of the deterministic segmented sums (grad_scatter.cu,
// scatter_rows.cu, texture_grad.cu, segment_sum.cu): a tile's items
// grouped by row in shared memory and each group summed in float64 in a
// fixed order, by warps over pieces of 64; the (row, tile) partial sums
// then sorted by row and added in sorted order (segment_sum.cu). No
// float atomics: the same inputs give the same bits on every run.
#pragma once

#include <cuda_runtime.h>

#include <cub/block/block_radix_sort.cuh>

// segment_sum.cu: the second pass's move of the tiles' scratch entries.
extern "C" int nvdr_segment_compact(const int* counts, const long long* offsets, int n_tiles,
                                    int cap, int K, const int* key_s, const double* part_s,
                                    int* key, double* partial, void* stream);

namespace nvdr_seg {

// The 32 lanes' partial sums added by a butterfly of shuffles, in a fixed
// order; every lane ends with the total.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// A run is summed in pieces of PIECE sorted positions, one warp a piece:
// lane l takes the piece's entries l and l + 32, the fixed butterfly adds
// the lanes; a run of several pieces then adds their sums in piece order.
constexpr int PIECE = 64;

// Block-wide minimum of a and of b over NT threads; every thread gets
// both. s_red holds 2 * NT / 32 ints.
template <int NT>
__device__ __forceinline__ void block_min2(int& a, int& b, int* s_red) {
    a = __reduce_min_sync(0xffffffffu, a);
    b = __reduce_min_sync(0xffffffffu, b);
    __syncthreads();
    if ((threadIdx.x & 31) == 0) {
        s_red[2 * (threadIdx.x >> 5)] = a;
        s_red[2 * (threadIdx.x >> 5) + 1] = b;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
        a = min(a, s_red[2 * w]);
        b = min(b, s_red[2 * w + 1]);
    }
}

// A tile's items grouped by key. NT threads hold ITEMS keys each (item
// thread * ITEMS + j), each in [0, range) for a live item and range for
// the others (range >= 1). A stable radix sort over the bits of range
// orders them by key, then by item; run r is the sorted positions
// [start[r], start[r + 1]) of key rkey[r], runs in ascending key order,
// and item[q] the item at sorted position q. run() returns the number of
// runs; start[runs] is the number of live items.
template <int NT, int ITEMS>
struct BlockRuns {
    static constexpr int N = NT * ITEMS;
    static constexpr int SLOTS = 2 * N / PIECE + 1;  // bounds the multi-piece runs' pieces
    using Sort = cub::BlockRadixSort<unsigned, NT, ITEMS, unsigned short>;
    struct Storage {
        union {
            typename Sort::TempStorage sort;
            unsigned key[N];  // the sorted keys
        } u;
        unsigned short item[N];
        int start[N + 1];
        unsigned rkey[N];
        int pfirst[N + 1], mfirst[N];
        unsigned short prun[N + N / PIECE + 1];
        int scan[NT / 32], mscan[NT / 32];
        int nlive;
    };

    __device__ static int run(Storage& s, unsigned (&keys)[ITEMS], unsigned range) {
        unsigned short vals[ITEMS];
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) vals[j] = static_cast<unsigned short>(threadIdx.x * ITEMS + j);
        __syncthreads();  // the storage may still be read by an earlier tile's walk
        Sort(s.u.sort).Sort(keys, vals, 0, 32 - __clz(range));
        __syncthreads();
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
            s.u.key[threadIdx.x * ITEMS + j] = keys[j];
            s.item[threadIdx.x * ITEMS + j] = vals[j];
        }
        __syncthreads();
        bool head[ITEMS];
        int nh = 0;
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
            const int q = threadIdx.x * ITEMS + j;
            const unsigned prev = q > 0 ? s.u.key[q - 1] : 0xffffffffu;
            const unsigned next = q + 1 < N ? s.u.key[q + 1] : range;
            head[j] = keys[j] < range && keys[j] != prev;
            nh += head[j] ? 1 : 0;
            if (keys[j] < range && next == range) s.nlive = q + 1;
        }
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        int incl = nh;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += y;
        }
        if (lane == 31) s.scan[warp] = incl;
        __syncthreads();
        int run = incl - nh, nruns = 0;
#pragma unroll
        for (int w = 0; w < NT / 32; ++w) {
            run += w < warp ? s.scan[w] : 0;
            nruns += s.scan[w];
        }
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
            if (head[j]) {
                s.start[run] = threadIdx.x * ITEMS + j;
                s.rkey[run] = keys[j];
                ++run;
            }
        }
        if (threadIdx.x == 0) s.start[nruns] = s.nlive;
        __syncthreads();
        return nruns;
    }

    // After run(): the runs cut into pieces of PIECE sorted positions, one
    // warp's work each. Run r holds pieces [pfirst[r], pfirst[r + 1]),
    // prun[piece] is the run of a piece; a run of more than one piece owns
    // the slots [mfirst[r], mfirst[r] + pieces) of the pieces' sums
    // (fewer than 2 N / PIECE + 1 in all). Returns the number of pieces.
    __device__ static int pieces(Storage& s, int nruns) {
        int np[ITEMS], nm[ITEMS], sp = 0, sm = 0;
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
            const int r = threadIdx.x * ITEMS + j;
            const int n = r < nruns ? s.start[r + 1] - s.start[r] : 0;
            np[j] = (n + PIECE - 1) / PIECE;
            nm[j] = np[j] > 1 ? np[j] : 0;
            sp += np[j];
            sm += nm[j];
        }
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        int ip = sp, im = sm;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int yp = __shfl_up_sync(0xffffffffu, ip, o);
            const int ym = __shfl_up_sync(0xffffffffu, im, o);
            if (lane >= o) {
                ip += yp;
                im += ym;
            }
        }
        if (lane == 31) {
            s.scan[warp] = ip;
            s.mscan[warp] = im;
        }
        __syncthreads();
        int p0 = ip - sp, m0 = im - sm, total = 0;
#pragma unroll
        for (int w = 0; w < NT / 32; ++w) {
            p0 += w < warp ? s.scan[w] : 0;
            m0 += w < warp ? s.mscan[w] : 0;
            total += s.scan[w];
        }
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
            const int r = threadIdx.x * ITEMS + j;
            if (r < nruns) {
                s.pfirst[r] = p0;
                s.mfirst[r] = m0;
                for (int i = 0; i < np[j]; ++i) s.prun[p0 + i] = static_cast<unsigned short>(r);
            }
            p0 += np[j];
            m0 += nm[j];
        }
        if (threadIdx.x == 0) s.pfirst[nruns] = total;
        __syncthreads();
        return total;
    }
};

}  // namespace nvdr_seg
