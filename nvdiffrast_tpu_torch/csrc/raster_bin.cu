// Per-tile binning of the rasterizer's records: the per-tile record
// lists that the binned sweep of rasterize.cu walks, and the segment
// starts of any sorted key array (also the texture gradient's).
//
// Replaces: nvdiffrast_tpu/ops/rasterize_pallas.py, the binning prepass
// of rasterize_fused (_sort_records :494, _csr_layout :527,
// _pack_records :414 and the use_remap / use_csr choice :1108-1109).
// Those chunk, remap and CSR layouts were the TPU's answer to its
// scalar-memory limits; a Hopper sweep wants, for each 16x16 tile, the
// indices of exactly the records whose AABB meets it, ascending.
//
// The record setup (raster_setup.cu) already counts the tiles each
// record's AABB meets. The caller (ops/rasterize_cuda.py, bin_records)
// scans those counts and reads the total back to the host, the one host
// sync of a binned forward, to allocate the keys. Then:
//   bin_emit      one thread per record writes, for each tile its AABB
//                 meets by the sweep's own tile test (bb.x <= 16t+15 and
//                 bb.z >= 16t per axis, as tile spans computed exactly in
//                 double), the entry's segment (set * tiles + tile; int16
//                 when the segments fit, as at 2048^2, else int32) and its
//                 record index, at the record's scan offset: record-major;
//   (a stable torch.sort of the segments: radix passes over 16 or 32 bits
//                 only, and the records of a segment stay ascending)
//   segment_starts  one thread per segment finds its start in the sorted
//                 segments by binary search; one thread per entry writes the
//                 record index, gathered through the sort's permutation,
//                 into the list.
// No float atomics and no order that depends on scheduling.
//
// Bound on the H100: bytes; each record's AABB and offset are read once
// (24 bytes), each entry's segment and record written once and read back
// once (6 or 8 bytes), each list entry written once; no arithmetic worth
// counting.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE = 16;  // rasterize.cu TILE
constexpr int BLOCK = 256;

// Tiles [first, last] of an n-tile axis whose pixels [16t, 16t+15] meet
// [lo, hi] (rasterize_cuda._tile_span); last < first when none.
__device__ __forceinline__ void tile_span(float lo, float hi, int n, int& first, int& last) {
    double f = ceil((static_cast<double>(lo) - (TILE - 1)) / TILE);
    double l = floor(static_cast<double>(hi) / TILE);
    first = 0;
    last = -1;
    if (!(f == f) || !(l == l)) return;
    f = f < 0.0 ? 0.0 : (f > n ? static_cast<double>(n) : f);
    l = l < -1.0 ? -1.0 : (l > n - 1 ? static_cast<double>(n - 1) : l);
    if (!(f <= l)) return;
    first = static_cast<int>(f);
    last = static_cast<int>(l);
}

template <typename K>
__global__ void __launch_bounds__(BLOCK)
bin_emit_kernel(const float4* __restrict__ aabb, const int64_t* __restrict__ offsets, int S,
                int T, int ntx, int nty, K* __restrict__ seg_out, int* __restrict__ rec_out) {
    const int s = blockIdx.x * BLOCK + threadIdx.x;
    if (s >= S) return;
    const float4 bb = aabb[s];
    int x0, x1, y0, y1;
    tile_span(bb.x, bb.z, ntx, x0, x1);
    tile_span(bb.y, bb.w, nty, y0, y1);
    const int set = s / T;
    const int rec = s - set * T;
    int64_t k = offsets[s];
    for (int ty = y0; ty <= y1; ++ty) {
        for (int tx = x0; tx <= x1; ++tx) {
            seg_out[k] = static_cast<K>((set * nty + ty) * ntx + tx);
            rec_out[k] = rec;
            ++k;
        }
    }
}

// Sorted keys [E] -> starts [n_seg + 1]: starts[g] = the first i with
// key_i >> shift >= g (E when none), by a binary search per segment, so
// a long run of empty segments costs no thread more than log2(E) loads.
// list [E], when given: vals[perm[i]] (perm: the sort's permutation), or
// else key_i & (2^shift - 1).
template <typename K>
__global__ void __launch_bounds__(BLOCK)
segment_starts_kernel(const K* __restrict__ keys, int64_t E, int shift, int64_t n_seg,
                      const int64_t* __restrict__ perm, const int* __restrict__ vals,
                      int* __restrict__ starts, int* __restrict__ list) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x;
    if (i <= n_seg) {
        int64_t lo = 0, hi = E;  // first index in [lo, hi] whose segment is >= i
        while (lo < hi) {
            const int64_t mid = (lo + hi) / 2;
            if ((static_cast<int64_t>(keys[mid]) >> shift) < i) lo = mid + 1; else hi = mid;
        }
        starts[i] = static_cast<int>(lo);
    }
    if (list != nullptr && i < E)
        list[i] = perm != nullptr
                      ? vals[perm[i]]
                      : static_cast<int>(static_cast<int64_t>(keys[i]) &
                                         ((int64_t{1} << shift) - 1));
}

}  // namespace

// aabb [S, 4] (16-byte aligned, S = sets * T), offsets [S] int64 exclusive
// scan of the setup's tile counts -> seg [E] (int16 when key_bytes is 2,
// else int32): the segment set * tiles + tile of each entry, and rec [E]
// int32: its record index within its set; record-major, so a stable sort
// by segment leaves the records of a segment ascending.
extern "C" int nvdr_bin_emit(const float* aabb, const int64_t* offsets, int S, int T, int ntx,
                             int nty, int key_bytes, void* seg, int* rec, void* stream) {
    if (S <= 0) return static_cast<int>(cudaGetLastError());
    const int grid = (S + BLOCK - 1) / BLOCK;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float4* bb = reinterpret_cast<const float4*>(aabb);
    if (key_bytes == 2)
        bin_emit_kernel<int16_t><<<grid, BLOCK, 0, st>>>(bb, offsets, S, T, ntx, nty,
                                                         static_cast<int16_t*>(seg), rec);
    else if (key_bytes == 4)
        bin_emit_kernel<int32_t><<<grid, BLOCK, 0, st>>>(bb, offsets, S, T, ntx, nty,
                                                         static_cast<int32_t*>(seg), rec);
    else
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}

// Sorted keys [E] (int16, int32 or int64 by key_bytes) -> starts
// [n_seg + 1] int32 and, when list is not null, list [E] int32:
// vals[perm[i]] when perm (int64) is given, else key & (2^shift - 1).
extern "C" int nvdr_segment_starts(const void* keys, long long E, int shift, long long n_seg,
                                   int key_bytes, const long long* perm, const int* vals,
                                   int* starts, int* list, void* stream) {
    if (E < 0 || n_seg < 0) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t n = E > n_seg + 1 ? E : n_seg + 1;
    const unsigned grid = static_cast<unsigned>((n + BLOCK - 1) / BLOCK);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int64_t* pm = reinterpret_cast<const int64_t*>(perm);
    switch (key_bytes) {
        case 2:
            segment_starts_kernel<int16_t><<<grid, BLOCK, 0, st>>>(
                static_cast<const int16_t*>(keys), E, shift, n_seg, pm, vals, starts, list);
            break;
        case 4:
            segment_starts_kernel<int32_t><<<grid, BLOCK, 0, st>>>(
                static_cast<const int32_t*>(keys), E, shift, n_seg, pm, vals, starts, list);
            break;
        case 8:
            segment_starts_kernel<int64_t><<<grid, BLOCK, 0, st>>>(
                static_cast<const int64_t*>(keys), E, shift, n_seg, pm, vals, starts, list);
            break;
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
