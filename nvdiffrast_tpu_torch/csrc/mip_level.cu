// The mip level of a pixel from its uv screen derivatives, and its vjp:
// one pass over the pixels each way.
//
// Replaces: no Pallas kernel. The JAX package computes the level in XLA
// (nvdiffrast_tpu/ops/texture.py, _mip_level_from_footprint_cols, and
// the clip beside it in pipeline_tex.py and texture()), where XLA fuses
// the elementwise chain. As PyTorch glue the forward was 33 launches and
// the vjp 104, each over full [N] columns: ~300 and ~1,050 bytes of
// device memory a pixel.
//
//   forward  flevel = clamp(footprint(da) [+ bias], 0, L-1)
//   vjp      g_da [4, N] from gfl, and g_lvl [N]: the gradient of the
//            level before the clip's input is NaN-masked (the bias's)
//
// with footprint(da) = 0.5 * log2(max(l2b + sqrt(l2n), 1e-38)), NaN -> 0
// (ops/texture.py mip_level_plain and level_vjp_plain, the rules of
// JAX's reverse pass: the square root's derivative is 0 where its
// argument is 0; max and min pass half the gradient on a tie).
//
// Bound on the H100: device-memory traffic, 20 bytes a pixel forward
// (4 derivatives read, the level written) and 36 backward (4
// derivatives and gfl read, 4 gradients written), 4 or 8 more with a
// bias. One thread a pixel in a grid-stride loop; no shared memory. da
// is read through its element and row strides, so the fused pipeline's
// [4, N] stream and texture()'s transposed [N, 4] view of uv_da are
// both read without a copy.
//
// Rounding: bit for bit what the plain twins give on CUDA tensors, where
// each PyTorch op is its own kernel and rounds on its own. Built with
// -fmad=false, the same operation order, IEEE division and square root,
// log2f; max / min / clamp propagate NaN as PyTorch's do; `x / scalar`
// is a multiply by the float reciprocal (div_true_kernel_cuda with a CPU
// scalar), `0.5 / x` a reciprocal, then a multiply (Tensor.__rtruediv__).
// The 1e-38 floor is a float32 subnormal; nothing flushes it to zero.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int BLOCK = 256;
constexpr int MAX_BLOCKS = 132 * 16;

// The Python scalars as PyTorch hands them to its kernels (double ->
// float).
constexpr float FLOOR = static_cast<float>(1e-38);
constexpr float L2A_MIN = static_cast<float>(1e-30);
// float32 log(2) (texture._LN2), and its reciprocal as div_true_kernel_cuda
// computes it on the host.
constexpr float LN2 = static_cast<float>(0.6931471805599453);
constexpr float INV_LN2 = 1.0f / LN2;

// torch.clamp(v, min=lo): NaN passes.
__device__ __forceinline__ float clamp_min(float v, float lo) {
    return isnan(v) ? v : fmaxf(v, lo);
}

// torch.clamp(v, lo, hi): NaN passes.
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
    return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// torch.maximum / torch.minimum: a NaN operand is the result.
__device__ __forceinline__ float nan_max(float a, float b) {
    return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
    return isnan(a) ? a : isnan(b) ? b : fminf(a, b);
}

// JAX's derivative of max/min(x, other) = out with respect to x
// (texture._tie): 1 where x is the result, half of it on a tie.
__device__ __forceinline__ float tie(float x, float out, float other) {
    return (x == out ? 1.0f : 0.0f) / (other == out ? 2.0f : 1.0f);
}

// The footprint's terms, in the twins' order.
struct Footprint {
    float dsdx, dsdy, dtdx, dtdy, A, B, C, t7, l2n, l2a, s, lms, fl0;
};

__device__ __forceinline__ Footprint footprint(const float* __restrict__ da, int64_t i,
                                               int64_t es, int64_t rs, float tw, float th) {
    Footprint f;
    f.dsdx = da[i * es] * tw;
    f.dsdy = da[rs + i * es] * tw;
    f.dtdx = da[2 * rs + i * es] * th;
    f.dtdy = da[3 * rs + i * es] * th;
    f.A = f.dsdx * f.dsdx + f.dtdx * f.dtdx;
    f.B = f.dsdy * f.dsdy + f.dtdy * f.dtdy;
    f.C = f.dsdx * f.dsdy + f.dtdx * f.dtdy;
    const float l2b = 0.5f * (f.A + f.B);
    f.t7 = 0.25f * (f.A - f.B);
    f.l2n = f.t7 * (f.A - f.B) + f.C * f.C;
    f.l2a = sqrtf(f.l2n);
    f.s = l2b + f.l2a;
    f.lms = clamp_min(f.s, FLOOR);
    f.fl0 = 0.5f * log2f(f.lms);
    return f;
}

template <bool DA, bool BIAS>
__global__ void __launch_bounds__(BLOCK)
mip_level_kernel(const float* __restrict__ da, int64_t es, int64_t rs,
                 const float* __restrict__ bias, float* __restrict__ out, int N, float tw,
                 float th, float top) {
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x; i < N;
         i += static_cast<int64_t>(gridDim.x) * BLOCK) {
        float fl = 0.0f;
        if (DA) {
            const float fl0 = footprint(da, i, es, rs, tw, th).fl0;
            fl = isnan(fl0) ? 0.0f : fl0;
        }
        if (BIAS) fl = fl + bias[i];
        out[i] = clamp(fl, 0.0f, top);
    }
}

template <bool DA, bool BIAS>
__global__ void __launch_bounds__(BLOCK)
level_vjp_kernel(const float* __restrict__ da, int64_t es, int64_t rs,
                 const float* __restrict__ gfl, const float* __restrict__ bias,
                 float* __restrict__ g_da, float* __restrict__ g_lvl, int N, float tw, float th,
                 float top) {
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * BLOCK + threadIdx.x; i < N;
         i += static_cast<int64_t>(gridDim.x) * BLOCK) {
        Footprint f;
        bool nan = false;
        float fl = 0.0f;
        if (DA) {
            f = footprint(da, i, es, rs, tw, th);
            nan = isnan(f.fl0);
            fl = nan ? 0.0f : f.fl0;
        }
        if (BIAS) fl = fl + bias[i];
        // jnp.clip: minimum(hi, maximum(lo, x)), each with its tie rule.
        const float y = nan_max(0.0f, fl);
        const float z = nan_min(top, y);
        float g = gfl[i] * tie(y, z, top);
        g = g * tie(fl, y, 0.0f);
        if (g_lvl != nullptr) g_lvl[i] = g;
        if (!DA) continue;
        g = nan ? 0.0f : g;
        g = ((0.5f * g) * INV_LN2) / f.lms;  // 0.5 * log(x) / log(2)
        const float g_s = g * tie(f.s, f.lms, FLOOR);
        const float coef = f.l2n > 0.0f ? (1.0f / clamp_min(f.l2a, L2A_MIN)) * 0.5f : 0.0f;
        const float g_l2n = coef * g_s;
        const float g_C = g_l2n * f.C + g_l2n * f.C;
        const float g_D2 = f.t7 * g_l2n;                // the second (A - B)
        const float g_D1 = 0.25f * (g_l2n * (f.A - f.B));  // the first, through t7
        const float g_s1 = 0.5f * g_s;                  // l2b = 0.5 * (A + B)
        const float g_A = (g_D2 + g_D1) + g_s1;
        const float g_B = ((-g_D2) + (-g_D1)) + g_s1;
        const float g_dtdy = (f.dtdx * g_C + f.dtdy * g_B) + g_B * f.dtdy;
        const float g_dtdx = (g_C * f.dtdy + f.dtdx * g_A) + g_A * f.dtdx;
        const float g_dsdy = (f.dsdx * g_C + f.dsdy * g_B) + g_B * f.dsdy;
        const float g_dsdx = (g_C * f.dsdy + f.dsdx * g_A) + g_A * f.dsdx;
        g_da[i] = g_dsdx * tw;
        g_da[N + i] = g_dsdy * tw;
        g_da[2 * static_cast<int64_t>(N) + i] = g_dtdx * th;
        g_da[3 * static_cast<int64_t>(N) + i] = g_dtdy * th;
    }
}

int grid_for(int N) { return std::min(N / BLOCK + 1, MAX_BLOCKS); }

}  // namespace

// da [4, N] float32 at element stride es and row stride rs (nullptr:
// no footprint, the level is the bias alone); bias [N] or nullptr ->
// out [N]. tex_w, tex_h: the base level's size; L: the number of levels.
extern "C" int nvdr_mip_level(const float* da, long long es, long long rs, const float* bias,
                              float* out, int N, int tex_w, int tex_h, int L, void* stream) {
    if (N <= 0) return static_cast<int>(cudaGetLastError());
    if (L < 1 || (da == nullptr && bias == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const float tw = static_cast<float>(tex_w), th = static_cast<float>(tex_h);
    const float top = static_cast<float>(L - 1);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int grid = grid_for(N);
    if (da != nullptr && bias != nullptr)
        mip_level_kernel<true, true><<<grid, BLOCK, 0, s>>>(da, es, rs, bias, out, N, tw, th, top);
    else if (da != nullptr)
        mip_level_kernel<true, false><<<grid, BLOCK, 0, s>>>(da, es, rs, bias, out, N, tw, th, top);
    else
        mip_level_kernel<false, true><<<grid, BLOCK, 0, s>>>(da, es, rs, bias, out, N, tw, th, top);
    return static_cast<int>(cudaGetLastError());
}

// da and bias as nvdr_mip_level's, gfl [N] -> g_da [4, N] contiguous
// (with da) and g_lvl [N], the bias's gradient (where not nullptr; needed
// without da).
extern "C" int nvdr_level_vjp(const float* da, long long es, long long rs, const float* gfl,
                              const float* bias, float* g_da, float* g_lvl, int N, int tex_w,
                              int tex_h, int L, void* stream) {
    if (N <= 0) return static_cast<int>(cudaGetLastError());
    if (L < 1 || (da == nullptr && bias == nullptr) || (da != nullptr && g_da == nullptr) ||
        (da == nullptr && g_lvl == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const float tw = static_cast<float>(tex_w), th = static_cast<float>(tex_h);
    const float top = static_cast<float>(L - 1);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int grid = grid_for(N);
#define NVDR_VJP(HAS_DA, HAS_BIAS)                                                         \
    level_vjp_kernel<HAS_DA, HAS_BIAS><<<grid, BLOCK, 0, s>>>(da, es, rs, gfl, bias, g_da, \
                                                              g_lvl, N, tw, th, top)
    if (da != nullptr && bias != nullptr)
        NVDR_VJP(true, true);
    else if (da != nullptr)
        NVDR_VJP(true, false);
    else
        NVDR_VJP(false, true);
#undef NVDR_VJP
    return static_cast<int>(cudaGetLastError());
}
