// Per-pixel lookup of per-triangle table rows: out[k, i] = tbl[k, rid[i]].
//
// Replaces: nvdiffrast_tpu/ops/gather.py, _take_pallas (table_take).
//
// The TPU kernel keeps the [K, T] table in VMEM and sweeps it in
// 128-entry chunks with lane-wise dynamic gathers, because Mosaic has no
// general gather. On this card a gather is an indexed load: one thread
// per pixel reads its id and loads the K entries of its table column
// (the table, a few hundred KB for the meshes the ops take, stays in
// L1/L2, and neighbouring pixels mostly share a triangle). An id outside
// [0, T) reads nothing and gives zeros, where the TPU kernel's callers
// point such ids at a zero column they appended.
//
// Bound on the H100: device-memory traffic, the id read and K floats
// written per pixel, plus the table once.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK)
table_take_kernel(const float* __restrict__ tbl, int cols, const int* __restrict__ rid,
                  float* __restrict__ out, int K, int N) {
    const int i = blockIdx.x * BLOCK + threadIdx.x;
    if (i >= N) return;
    const int r = rid[i];
    const bool ok = r >= 0 && r < cols;
    for (int k = 0; k < K; ++k)
        out[static_cast<size_t>(k) * N + i] = ok ? tbl[static_cast<size_t>(k) * cols + r] : 0.0f;
}

}  // namespace

// tbl [K, cols] float32, rid [N] int32 -> out [K, N] float32.
extern "C" int nvdr_table_take(const float* tbl, int cols, const int* rid, float* out, int K,
                               int N, void* stream) {
    if (N <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
    if (cols <= 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int grid = (N + BLOCK - 1) / BLOCK;
    table_take_kernel<<<grid, BLOCK, 0, s>>>(tbl, cols, rid, out, K, N);
    return static_cast<int>(cudaGetLastError());
}
