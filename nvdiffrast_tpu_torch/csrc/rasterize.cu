// Rasterizer: coverage, depth test and shading to (u, v, z/w, id) in one
// pass over per-triangle records.
//
// Replaces: nvdiffrast_tpu/ops/rasterize_pallas.py, rasterize_fused with
// its kernel body _make_kernel, in all its modes: instance and range
// mode, with and without emit_db, the zbuf output, the peel cull,
// viewport bands, and the binned sweep that takes the place of the TPU's
// dense / remap / CSR layouts. The db variant also keeps the winner's
// six edge gradients (cx0, cy0, cx1, cy1, cx2, cy2) in registers and
// writes the four bary pixel derivatives (dudx, dudy, dvdx, dvdy) in the
// final step.
//
// Input: records [S, T, 16] f32 from the record setup (raster_setup.cu;
// its plain twin is ops/rasterize_cuda.py build_records: 3
// winding-normalized affine edge functions (c, d/dfx, d/dfy), the z
// plane, the w plane, id+1 or 1e30 when invalid), their screen AABBs
// [S, T, 4] (xmin, ymin, xmax, ymax in band-local pixel-index units,
// coverage slop included; empty = (+1e30, -1e30)) and, unbinned, the
// union box of each chunk of 256 records. S = B in instance mode (one set
// per image) and S = 1 in range mode, where every image reads the one
// set and masks ids against its [start, start + count) window of ranges
// [B, 2].
//
// Design: one block per 16x16 pixel tile and image, one thread per
// pixel; warp w owns the 8x4 pixel block (w % 2, w / 2) of the tile. The
// block streams its candidate records through shared memory 256 at a
// time: unbinned, the records of every 256-record chunk whose box meets
// the tile (the chunk boxes are tested 256 at a time first, so a tile
// reads 16 bytes per chunk rather than per record, and in range mode only
// the chunks of the image's window), each thread testing one record's
// AABB against the tile; binned, only the tile's own segment of the
// per-tile lists of raster_bin.cu (ascending record index, exactly the
// records whose AABB meets the tile by the same test). A warp-ballot
// compaction keeps the candidates in id order, so every pixel merges
// them in ascending id order, and the binned sweep equals the unbinned
// one bit for bit. Before a candidate's ~34 operations, each warp tests
// the candidate's AABB against its 8x4 pixel block, a test uniform over
// the warp; the AABB includes the coverage slop, so a candidate it
// rejects covers none of the warp's pixels, and the plain twin evaluates
// exactly the same (candidate, 8x4 block) pairs. The running (pz, pw, id,
// a0, a1, a2) state lives in registers; the outputs are written once.
// Each pixel's merge stays one sequential chain in one thread: splitting
// a tile's candidates across threads and merging partial minima would not
// be exact, because the cross-multiplied (z/w, id) order is not
// associative under rounding.
//
// Modes, all arguments of one kernel (null pointer = off; db, binning
// and peel also pick one of 8 compiled variants):
//   ranges  range-mode id windows (float bounds start+1, start+1+count);
//   peel    [B, H, W] previous layer's zbuf; a fragment survives only if
//           fl(pz / pw) > peel. The IEEE quotient is the one the zbuf
//           output stores, so the previous winner is culled exactly;
//   zbuf    [B, H, W] output, pz / pw of the winner, +inf where empty;
//   y0      viewport: pixel row py of the band is row py + y0 of the
//           full image (xs, xo, ys, yo come from the full height);
//   api     the outputs' layout, a uniform branch in the final step only:
//           0 writes each output as its own [B, H, W] column; 1 writes
//           the rasterize op's rast [B, H, W, 4] (u, v, zw, idf) and
//           rast_db [B, H, W, 4] (dudx, dudy, dvdx, dvdy), one 16-byte
//           store each a pixel, so a warp's 8x4 block writes 4 full
//           128-byte lines of each.
//
// Bound on the H100: instruction throughput of the per-pixel edge
// evaluations (~34 operations a fragment, now only for the candidates
// whose AABB meets the warp's block) and the latency of the candidate
// stream (a dependent load chain, list -> record, and three barriers a
// batch); device-memory traffic is the record stream (L2 resident) and
// one write of each output per pixel. Reading every record's AABB in
// every tile would be 16,384 tiles x 3,968 records x 16 bytes = 1 GB of
// L2 reads at the bench scene; the chunk boxes cut that to the chunks
// that meet the tile.
//
// Rounding: built with -fmad=false, and the lines where coverage
// depends on the last bit use __fmul_rn/__fadd_rn/__fdiv_rn explicitly,
// in the operation order of the reference, so the plain PyTorch twin
// (rasterize_records_plain) reproduces this kernel bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;            // tile edge in pixels (RASTER_TILE)
constexpr int NT = TILE * TILE;     // threads per block = records per batch
constexpr int REC = 16;             // floats per record
constexpr int SREC = 19;            // record + near-clip cut line (3)
constexpr int WX = 8, WY = 4;       // pixel block of one warp (rasterize_cuda.CULL)
constexpr float BIG = 1e30f;
constexpr float ID_INVALID = 1e30f;
constexpr float ID_VALID_THRESH = 1e29f;
constexpr float CLIP_EPS = 1e-9f;

// jnp.clip / jnp.maximum semantics: a NaN operand propagates.
__device__ __forceinline__ float clip_nan(float x, float lo, float hi) {
    return x != x ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float max_nan(float x, float y) {
    return x != x ? x : fmaxf(x, y);
}

// (s0 + s1*fx) + s2*fy, each operation rounded on its own.
__device__ __forceinline__ float affine(const float* s, float fx, float fy) {
    return __fadd_rn(__fadd_rn(s[0], __fmul_rn(s[1], fx)), __fmul_rn(s[2], fy));
}

// Exclusive on-edge tie rule: a pixel exactly on an edge belongs to the
// side whose edge gradient points +y, or +x when it is horizontal.
__device__ __forceinline__ bool tie(const float* s) {
    return (s[2] > 0.0f) || ((s[2] == 0.0f) && (s[1] > 0.0f));
}

__device__ __forceinline__ bool inside_edge(float a, const float* s) {
    return (a > 0.0f) || ((a == 0.0f) && tie(s));
}

struct Args {
    const float* rec;         // [S, T, 16]
    const float4* aabb;       // [S, T, 4]
    const float4* boxes;      // [S, ceil(T / NT), 4] chunk boxes (unbinned)
    const int* tile_start;    // [S * tiles + 1] segment starts (binned)
    const int* tile_list;     // [E] record index within its set (binned)
    const int* tile_order;    // [S * tiles] tiles in launch order (binned) or null
    const int* ranges;        // [B, 2] (start, count) or null
    const float* peel;        // [B, H, W] or null
    float* out[9];            // u, v, zw, idf, dudx, dudy, dvdx, dvdy, zbuf
    int T, sets, H, W, y0, api;
    float xs, xo, ys, yo;
};

// Running lexicographic (z/w, id) minimum of one pixel and the winner's
// edges; cx*, cy* (the winner's edge gradients) only with DB.
struct State {
    float az = BIG, aw = 1.0f, aid = ID_INVALID;
    float pa0 = 0.0f, pa1 = 0.0f, pa2 = 0.0f;
    float cx0 = 0.0f, cy0 = 0.0f, cx1 = 0.0f, cy1 = 0.0f, cx2 = 0.0f, cy2 = 0.0f;
};

struct Shared {
    float rec[NT][SREC];  // the batch's candidates, compacted in id order
    float4 box[NT];       // their AABBs, for the warp's test
    int count[NT / 32];
    int chunk[NT];        // chunks whose box meets the tile (unbinned)
    short hits[NT / 32][NT];  // each warp's candidates that meet its block
};

// The pixel of this thread and the rectangle of its warp.
struct Pix {
    float fx, fy;               // clip-space pixel center
    float wx0, wx1, wy0, wy1;   // the warp's WX x WY pixel block
    float peel;
    bool in_image;
};

// One candidate at one pixel: its edge values, depth plane values and
// whether it covers the pixel and passes the depth-range, clip and peel
// tests.
struct Frag {
    const float* s;
    float a0, a1, a2, pz, pw;
    bool ok;
};

template <bool PEEL>
__device__ __forceinline__ Frag evaluate(const float* s, const Pix& p) {
    Frag f;
    f.s = s;
    f.a0 = affine(s + 0, p.fx, p.fy);
    f.a1 = affine(s + 3, p.fx, p.fy);
    f.a2 = affine(s + 6, p.fx, p.fy);
    const bool cov = inside_edge(f.a0, s + 0) && inside_edge(f.a1, s + 3) &&
                     inside_edge(f.a2, s + 6);
    f.pz = affine(s + 9, p.fx, p.fy);
    f.pw = affine(s + 12, p.fx, p.fy);
    const float cut = affine(s + 16, p.fx, p.fy);
    // Rounded-depth peel cull (pw > 0 is tested first).
    f.ok = cov && (cut >= 0.0f) && (f.pw > 0.0f) && (fabsf(f.pz) <= f.pw) &&
           (s[15] < ID_VALID_THRESH) && (!PEEL || __fdiv_rn(f.pz, f.pw) > p.peel);
    return f;
}

// The running minimum's step: cross-multiplied depth order; equal depth
// -> lower id.
template <bool DB>
__device__ __forceinline__ void merge(const Frag& f, State& st) {
    if (!f.ok) return;
    const float idf = f.s[15];
    const float lhs = __fmul_rn(f.pz, st.aw);
    const float rhs = __fmul_rn(st.az, f.pw);
    if ((lhs < rhs) || ((lhs == rhs) && (idf < st.aid))) {
        st.az = f.pz;
        st.aw = f.pw;
        st.aid = idf;
        st.pa0 = f.a0;
        st.pa1 = f.a1;
        st.pa2 = f.a2;
        if (DB) {
            st.cx0 = f.s[1];
            st.cy0 = f.s[2];
            st.cx1 = f.s[4];
            st.cy1 = f.s[5];
            st.cx2 = f.s[7];
            st.cy2 = f.s[8];
        }
    }
}

// One batch of up to NT candidates: thread j offers record i when `hit`
// (it meets the tile and lies in the range window). The hits are
// compacted into shared memory in thread order, which is ascending id
// order, and every pixel merges them in that order. Each warp then lists
// the candidates whose AABB meets its pixel block (32 tests at a time):
// a candidate whose AABB (which includes the coverage slop) misses every
// pixel of the warp changes none of their states. The warp's pixels run
// the ~34 operations of two listed candidates at once (but in the peel
// variant), independent of each other, and merge them in order. Called by
// every thread of the block.
template <bool DB, bool PEEL>
__device__ __forceinline__ void merge_batch(bool hit, int i, float4 bb, const float* rec_s,
                                            Shared& sm, const Pix& p, State& st) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) sm.count[warp] = __popc(m);
    __syncthreads();
    int off = 0, n = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) {
        const int c = sm.count[w];
        off += (w < warp) ? c : 0;
        n += c;
    }
    if (hit) {
        const int k = off + __popc(m & ((1u << lane) - 1u));
        float* dst = sm.rec[k];
        const float4* src = reinterpret_cast<const float4*>(rec_s + static_cast<size_t>(i) * REC);
        float s[REC];
#pragma unroll
        for (int q = 0; q < REC / 4; ++q) {
            const float4 f = src[q];
            s[4 * q + 0] = f.x;
            s[4 * q + 1] = f.y;
            s[4 * q + 2] = f.z;
            s[4 * q + 3] = f.w;
        }
#pragma unroll
        for (int q = 0; q < REC; ++q) dst[q] = s[q];
        // Near-clip cut line pw - eps*(a0 + a1 + a2), as affine coefficients.
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float sum = __fadd_rn(__fadd_rn(s[c], s[3 + c]), s[6 + c]);
            dst[REC + c] = __fsub_rn(s[12 + c], __fmul_rn(CLIP_EPS, sum));
        }
        sm.box[k] = bb;
    }
    __syncthreads();
    // The warp's own candidates: those whose AABB meets its pixel block,
    // tested 32 at a time and listed in id order.
    short* hl = sm.hits[warp];
    int nh = 0;
    for (int base = 0; base < n; base += 32) {
        const int k = base + lane;
        bool mh = false;
        if (k < n) {
            const float4 b = sm.box[k];
            mh = (b.x <= p.wx1) && (b.z >= p.wx0) && (b.y <= p.wy1) && (b.w >= p.wy0);
        }
        const unsigned bm = __ballot_sync(0xffffffffu, mh);
        if (mh) hl[nh + __popc(bm & ((1u << lane) - 1u))] = static_cast<short>(k);
        nh += __popc(bm);
    }
    __syncwarp();
    if (p.in_image) {
        // Two candidates evaluated at once (independent), merged in order:
        // it shortens the long per-pixel chains of a big mesh's crowded
        // tiles (1 M triangles: 1.39 against 1.46 ms on the H100), but the
        // peel variant, with its division, runs one at a time (0.364
        // against 0.435 ms a peeled layer).
        int h = 0;
        if (!PEEL) {
            for (; h + 1 < nh; h += 2) {
                const Frag f0 = evaluate<PEEL>(sm.rec[hl[h]], p);
                const Frag f1 = evaluate<PEEL>(sm.rec[hl[h + 1]], p);
                merge<DB>(f0, st);
                merge<DB>(f1, st);
            }
        }
        for (; h < nh; ++h) merge<DB>(evaluate<PEEL>(sm.rec[hl[h]], p), st);
    }
    __syncthreads();
}

// At most 51 registers, so that 5 blocks share an SM: on the H100 that
// beats the unbounded 54-64 registers (4 blocks) in every mode but db
// (+3 %), by 5-8 % binned and in range mode; 6 or 7 blocks spill.
template <bool DB, bool BINNED, bool PEEL>
__global__ void __launch_bounds__(NT, 5) raster_kernel(const Args a) {
    __shared__ Shared sm;

    // The block's tile: its grid position, or (binned, instance mode) the
    // tile that tile_order puts there, longest list first, so the longest
    // lists start in the first wave.
    int b = blockIdx.z, tyi = blockIdx.y, txi = blockIdx.x;
    if (BINNED && a.tile_order != nullptr) {
        const int tiles = gridDim.x * gridDim.y;
        const int lin = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
        const int seg = a.tile_order[lin];
        b = seg / tiles;
        tyi = (seg - b * tiles) / gridDim.x;
        txi = seg - b * tiles - tyi * gridDim.x;
    }
    const int set = a.sets > 1 ? b : 0;
    const int tx0 = txi * TILE;
    const int ty0 = tyi * TILE;
    // Warp w covers the WX x WY block (w % 2, w / 2) of the tile.
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int bx0 = tx0 + (warp % (TILE / WX)) * WX;
    const int by0 = ty0 + (warp / (TILE / WX)) * WY;
    const int px = bx0 + lane % WX;
    const int py = by0 + lane / WX;
    const int T = a.T;

    Pix p;
    p.in_image = (px < a.W) && (py < a.H);
    // Pixel center in clip space, (p * s) + o, on the full image's row.
    p.fx = __fadd_rn(__fmul_rn(static_cast<float>(px), a.xs), a.xo);
    p.fy = __fadd_rn(__fmul_rn(static_cast<float>(py + a.y0), a.ys), a.yo);
    p.wx0 = static_cast<float>(bx0);
    p.wx1 = static_cast<float>(bx0 + WX - 1);
    p.wy0 = static_cast<float>(by0);
    p.wy1 = static_cast<float>(by0 + WY - 1);
    p.peel = (PEEL && p.in_image) ? a.peel[(static_cast<size_t>(b) * a.H + py) * a.W + px] : 0.0f;
    const float ftx0 = static_cast<float>(tx0);
    const float ftx1 = static_cast<float>(tx0 + TILE - 1);
    const float fty0 = static_cast<float>(ty0);
    const float fty1 = static_cast<float>(ty0 + TILE - 1);
    auto meets_tile = [&](float4 bb) {
        return (bb.y <= fty1) && (bb.w >= fty0) && (bb.x <= ftx1) && (bb.z >= ftx0);
    };

    // Range-mode id window as float bounds (ids are +1); all ids pass
    // without ranges. The chunks outside [start, start + count) are skipped
    // whole (exact while ids are exact floats, T < 2^24).
    const int n_chunks = (T + NT - 1) / NT;
    int c_lo = 0, c_hi = n_chunks;
    float start_f = 0.0f, end_f = 2.0f * ID_VALID_THRESH;
    if (a.ranges != nullptr) {
        const int r0 = a.ranges[2 * b], rn = a.ranges[2 * b + 1];
        start_f = __fadd_rn(static_cast<float>(r0), 1.0f);
        end_f = __fadd_rn(start_f, static_cast<float>(rn));
        if (T < (1 << 24)) {
            const long long lo = r0, hi = static_cast<long long>(r0) + rn;
            c_lo = static_cast<int>(lo <= 0 ? 0 : (lo >= T ? n_chunks : lo / NT));
            c_hi = static_cast<int>(hi <= 0 ? 0 : (hi >= T ? n_chunks : (hi + NT - 1) / NT));
        }
    }
    auto in_window = [&](int i) {
        const float idf = a.rec[(static_cast<size_t>(set) * T + i) * REC + 15];
        return (idf >= start_f) && (idf < end_f);
    };

    State st;
    const float* rec_s = a.rec + static_cast<size_t>(set) * T * REC;
    const float4* aabb_s = a.aabb + static_cast<size_t>(set) * T;

    if (BINNED) {
        // The tile's own segment of the per-tile lists (raster_bin.cu).
        const int seg = (set * gridDim.y + tyi) * gridDim.x + txi;
        const int lo = a.tile_start[seg];
        const int hi = a.tile_start[seg + 1];
        for (int base = lo; base < hi; base += NT) {
            const int j = base + threadIdx.x;
            bool hit = j < hi;
            int i = 0;
            float4 bb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (hit) {
                i = a.tile_list[j];
                bb = aabb_s[i];
                if (a.ranges != nullptr) hit = in_window(i);
            }
            merge_batch<DB, PEEL>(hit, i, bb, rec_s, sm, p, st);
        }
    } else {
        // Every record, chunk by chunk: first the chunk boxes (NT at a
        // time, compacted in order), then the records of each chunk whose
        // box meets the tile. A record of a skipped chunk misses the tile.
        const float4* boxes_s = a.boxes + static_cast<size_t>(set) * n_chunks;
        for (int cb = c_lo; cb < c_hi; cb += NT) {
            const int c = cb + threadIdx.x;
            const bool chit = (c < c_hi) && meets_tile(boxes_s[c]);
            const unsigned m = __ballot_sync(0xffffffffu, chit);
            if (lane == 0) sm.count[warp] = __popc(m);
            __syncthreads();
            int off = 0, n = 0;
#pragma unroll
            for (int w = 0; w < NT / 32; ++w) {
                const int cnt = sm.count[w];
                off += (w < warp) ? cnt : 0;
                n += cnt;
            }
            if (chit) sm.chunk[off + __popc(m & ((1u << lane) - 1u))] = c;
            __syncthreads();
            for (int h = 0; h < n; ++h) {
                const int i = sm.chunk[h] * NT + threadIdx.x;
                bool hit = false;
                float4 bb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                if (i < T) {
                    bb = aabb_s[i];
                    hit = meets_tile(bb);
                    if (hit && a.ranges != nullptr) hit = in_window(i);
                }
                merge_batch<DB, PEEL>(hit, i, bb, rec_s, sm, p, st);
            }
            __syncthreads();
        }
    }

    if (!p.in_image) return;
    // Final shading (rasterize_pallas.py, final grid step).
    const bool valid = st.aid < ID_VALID_THRESH;
    const float iw = 1.0f / __fadd_rn(__fadd_rn(st.pa0, st.pa1), st.pa2);
    float b0 = clip_nan(__fmul_rn(st.pa0, iw), 0.0f, 1.0f);
    float b1 = clip_nan(__fmul_rn(st.pa1, iw), 0.0f, 1.0f);
    const float bs = 1.0f / max_nan(__fadd_rn(b0, b1), 1.0f);
    b0 = __fmul_rn(b0, bs);
    b1 = __fmul_rn(b1, bs);
    const float depth = __fdiv_rn(st.az, st.aw);
    const size_t o = (static_cast<size_t>(b) * a.H + py) * a.W + px;
    const float4 r = make_float4(valid ? b0 : 0.0f, valid ? b1 : 0.0f,
                                 valid ? clip_nan(depth, -1.0f, 1.0f) : 0.0f,
                                 valid ? st.aid : 0.0f);
    if (a.api) {
        reinterpret_cast<float4*>(a.out[0])[o] = r;
    } else {
        a.out[0][o] = r.x;
        a.out[1][o] = r.y;
        a.out[2][o] = r.z;
        a.out[3][o] = r.w;
    }
    if (a.out[8] != nullptr) a.out[8][o] = valid ? depth : INFINITY;
    if (DB) {
        // Bary pixel derivatives (rasterize_pallas.py final step, emit_db).
        const float da0dx = -st.cx0, da1dx = -st.cx1, da2dx = -st.cx2;
        const float da0dy = -st.cy0, da1dy = -st.cy1, da2dy = -st.cy2;
        const float datdx = __fadd_rn(__fadd_rn(da0dx, da1dx), da2dx);
        const float datdy = __fadd_rn(__fadd_rn(da0dy, da1dy), da2dy);
        const float dfxdx = __fmul_rn(a.xs, iw);
        const float dfydy = __fmul_rn(a.ys, iw);
        const float dudx = __fmul_rn(dfxdx, __fsub_rn(__fmul_rn(b0, datdx), da0dx));
        const float dudy = __fmul_rn(dfydy, __fsub_rn(__fmul_rn(b0, datdy), da0dy));
        const float dvdx = __fmul_rn(dfxdx, __fsub_rn(__fmul_rn(b1, datdx), da1dx));
        const float dvdy = __fmul_rn(dfydy, __fsub_rn(__fmul_rn(b1, datdy), da1dy));
        const float4 d = make_float4(valid ? dudx : 0.0f, valid ? dudy : 0.0f,
                                     valid ? dvdx : 0.0f, valid ? dvdy : 0.0f);
        if (a.api) {
            reinterpret_cast<float4*>(a.out[4])[o] = d;
        } else {
            a.out[4][o] = d.x;
            a.out[5][o] = d.y;
            a.out[6][o] = d.z;
            a.out[7][o] = d.w;
        }
    }
}

}  // namespace

// The one entry point of every mode (ops/rasterize_cuda.py picks the mode
// and keeps a launch count per mode):
//   rec [S, T, 16], aabb [S, T, 4] (16-byte aligned; S = sets, 1 or B);
//   boxes [S, ceil(T / 256), 4] chunk boxes (unbinned);
//   tile_start [S * tiles + 1], tile_list [E] (both null: unbinned);
//   tile_order [S * tiles] a permutation of the tiles (binned, S = B) or null;
//   ranges [B, 2] int32 or null; peel [B, H, W] or null;
//   api 0: u, v, zw, idf [B, H, W]; dudx, dudy, dvdx, dvdy [B, H, W] or
//   all null (no db); api 1: u is rast [B, H, W, 4] and dudx rast_db
//   [B, H, W, 4] or null (no db), both 16-byte aligned, and v, zw, idf,
//   dudy, dvdx, dvdy are null; zbuf [B, H, W] or null.
extern "C" int nvdr_rasterize(const float* rec, const float* aabb, const float* boxes,
                              const int* tile_start, const int* tile_list,
                              const int* tile_order, const int* ranges, const float* peel,
                              float* u, float* v, float* zw, float* idf, float* dudx,
                              float* dudy, float* dvdx, float* dvdy, float* zbuf, int B, int T,
                              int sets, int H, int W, int y0, int api, float xs, float xo,
                              float ys, float yo, void* stream) {
    if (B <= 0 || H <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
    if (api && (reinterpret_cast<size_t>(u) % 16 || reinterpret_cast<size_t>(dudx) % 16 ||
                v != nullptr || zw != nullptr || idf != nullptr || dudy != nullptr ||
                dvdx != nullptr || dvdy != nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    if ((tile_start == nullptr) != (tile_list == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    const bool binned = tile_list != nullptr;
    if (!binned && boxes == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (tile_order != nullptr && (!binned || sets != B))
        return static_cast<int>(cudaErrorInvalidValue);
    Args a{rec, reinterpret_cast<const float4*>(aabb), reinterpret_cast<const float4*>(boxes),
           tile_start, tile_list, tile_order, ranges, peel,
           {u, v, zw, idf, dudx, dudy, dvdx, dvdy, zbuf}, T, sets, H, W, y0, api,
           xs, xo, ys, yo};
    const dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, B);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // The 8 variants: db, binned and peel are compile-time flags.
    const int variant = (dudx != nullptr) | (binned << 1) | ((peel != nullptr) << 2);
    switch (variant) {
        case 0: raster_kernel<false, false, false><<<grid, NT, 0, s>>>(a); break;
        case 1: raster_kernel<true, false, false><<<grid, NT, 0, s>>>(a); break;
        case 2: raster_kernel<false, true, false><<<grid, NT, 0, s>>>(a); break;
        case 3: raster_kernel<true, true, false><<<grid, NT, 0, s>>>(a); break;
        case 4: raster_kernel<false, false, true><<<grid, NT, 0, s>>>(a); break;
        case 5: raster_kernel<true, false, true><<<grid, NT, 0, s>>>(a); break;
        case 6: raster_kernel<false, true, true><<<grid, NT, 0, s>>>(a); break;
        default: raster_kernel<true, true, true><<<grid, NT, 0, s>>>(a); break;
    }
    return static_cast<int>(cudaGetLastError());
}
