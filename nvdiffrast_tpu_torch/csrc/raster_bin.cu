// Per-tile binning of the rasterizer's records: the per-tile record
// lists that the binned sweep of rasterize.cu walks.
//
// Replaces: nvdiffrast_tpu/ops/rasterize_pallas.py, the binning prepass
// of rasterize_fused (_sort_records :494, _csr_layout :527,
// _pack_records :414 and the use_remap / use_csr choice :1108-1109).
// Those chunk, remap and CSR layouts were the TPU's answer to its
// scalar-memory limits; a Hopper sweep wants, for each 16x16 tile, the
// indices of exactly the records whose AABB meets it, ascending.
//
// Two kernels, one thread per record:
//   bin_count  the number of tiles the record's AABB meets, by the
//              rasterizer's own tile test (bb.x <= 16t+15 and bb.z >= 16t
//              per axis, as tile spans [first, last] computed exactly in
//              double: first = ceil((lo - 15) / 16), last = floor(hi / 16),
//              clipped to the grid; NaN bounds meet no tile);
//   bin_emit   writes one key (segment << 24 | record) for each of those
//              tiles at the record's exclusive-scan offset, so the keys
//              come out in record order. segment = set * tiles + tile.
// The caller (ops/rasterize_cuda.py, bin_records) scans the counts,
// reads the total back to the host once to allocate the keys, sorts the
// keys (unique, so any sort gives one order: ascending record index
// within each tile) and takes the segment starts with searchsorted.
// No float atomics and no order that depends on scheduling.
//
// Bound on the H100: bytes; each record's AABB is read once (16 bytes)
// and each key written once (8 bytes).
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

__global__ void __launch_bounds__(BLOCK)
bin_count_kernel(const float4* __restrict__ aabb, int S, int ntx, int nty,
                 int* __restrict__ counts) {
    const int s = blockIdx.x * BLOCK + threadIdx.x;
    if (s >= S) return;
    const float4 bb = aabb[s];
    int x0, x1, y0, y1;
    tile_span(bb.x, bb.z, ntx, x0, x1);
    tile_span(bb.y, bb.w, nty, y0, y1);
    counts[s] = (x1 - x0 + 1) * (y1 - y0 + 1);
}

__global__ void __launch_bounds__(BLOCK)
bin_emit_kernel(const float4* __restrict__ aabb, const int64_t* __restrict__ offsets, int S,
                int T, int ntx, int nty, int64_t* __restrict__ keys) {
    const int s = blockIdx.x * BLOCK + threadIdx.x;
    if (s >= S) return;
    const float4 bb = aabb[s];
    int x0, x1, y0, y1;
    tile_span(bb.x, bb.z, ntx, x0, x1);
    tile_span(bb.y, bb.w, nty, y0, y1);
    const int set = s / T;
    const int64_t rec = s - static_cast<int64_t>(set) * T;
    int64_t k = offsets[s];
    for (int ty = y0; ty <= y1; ++ty) {
        for (int tx = x0; tx <= x1; ++tx) {
            const int64_t seg = (static_cast<int64_t>(set) * nty + ty) * ntx + tx;
            keys[k++] = (seg << 24) | rec;
        }
    }
}

}  // namespace

// aabb [S, 4] (16-byte aligned, S = sets * T) -> counts [S] int32.
extern "C" int nvdr_bin_count(const float* aabb, int S, int ntx, int nty, int* counts,
                              void* stream) {
    if (S <= 0) return static_cast<int>(cudaGetLastError());
    bin_count_kernel<<<(S + BLOCK - 1) / BLOCK, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(aabb), S, ntx, nty, counts);
    return static_cast<int>(cudaGetLastError());
}

// aabb [S, 4], offsets [S] int64 exclusive scan of the counts -> keys [E]
// int64, segment << 24 | record index within its set (T < 2^24).
extern "C" int nvdr_bin_emit(const float* aabb, const int64_t* offsets, int S, int T, int ntx,
                             int nty, int64_t* keys, void* stream) {
    if (S <= 0) return static_cast<int>(cudaGetLastError());
    bin_emit_kernel<<<(S + BLOCK - 1) / BLOCK, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const float4*>(aabb), offsets, S, T, ntx, nty, keys);
    return static_cast<int>(cudaGetLastError());
}
