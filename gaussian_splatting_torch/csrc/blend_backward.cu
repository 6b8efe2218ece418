// K5 blend backward: the gradient of the packed blend output (R, G, B, T,
// inverse depth) with respect to the 10 blend fields of every instance,
// written once per sorted slot, (cap, 10), with no atomics.
//
// Replaces gaussian_splatting_tpu/ops/blend_pallas.py::
// blend_backward_compact_pallas (_backward_kernel_compact,
// _backward_one_tile_compact, _bwd_chunk_math).  Same semantics: a forward
// replay per pixel that carries the transmittance T and the prefix
// Bq = sum(w q) of the cotangent-weighted colour, q = r dR + g dG + b dB +
// invd dD, so the suffix that the reference's back-to-front pass sums is
// Ctot_q - Bq, with Ctot_q = C . dC + D dD + T_final dT from the saved
// forward output.  Per (pixel, instance), with w = alpha T:
//   contributes iff power <= POWER_EPS, alpha >= 1/255 and the instance's
//   stream position is below the pixel's NB (the forward's contributor set)
//   gl = w q - alpha / (1 - alpha) (Ctot_q - Bq_inclusive), 0 where capped
//   dL/dmean_x = -(a sum(gl dx) + b sum(gl dy)),  dx = mean_x - px
//   dL/dmean_y = -(c sum(gl dy) + b sum(gl dx))
//   dL/d(a, b, c) = (-0.5 sum(gl dx^2), -sum(gl dx dy), -0.5 sum(gl dy^2))
//   dL/dopacity = sum(gl) / opacity (0 where opacity is 0)
//   dL/d(r, g, b, invd) = sum(w dC), sums over the tile's 256 pixels.
//
// Layout: one block per tile, 128 threads of two vertically adjacent
// pixels each; warp w covers the 8x8 quarter (w & 1, w >> 1) of the tile.
// The tile's instances are staged BATCH at a time in shared memory.  Each
// warp-step (one staged instance against a warp's 64 pixels) replays 17
// float operations per pixel, and where any pixel contributes, 27 more for
// its 10 terms, which the warp then sums over its pixels.
//
// What bounds it on this card: instruction issue, not the float operations.
// Summing 10 terms over a warp by a shuffle-down tree each costs 50
// shuffles per contributing warp-step, and Hopper issues one warp shuffle
// per SM per clock; scalar reads of the 10 fields and scalar stores of the
// 10 sums cost 20 more shared-memory instructions per warp-step.  The
// design:
//   - a reduce-scatter: an xor butterfly over lane offsets 16, 8, 4, 2, 1
//     that halves the terms each lane carries at every level (10 -> 5 -> 3
//     -> 2 -> 1 -> 1), 12 shuffles; afterwards 10 lanes hold the 10 warp
//     sums and store them with one shared-memory instruction;
//   - two pixels per thread: a thread adds its two pixels' terms before the
//     butterfly, so one staged read, one butterfly and one store serve 64
//     pixels, and a warp skips the instances at or past its pixels' largest
//     NB (it writes their zero sums without the replay);
//   - each instance's 10 fields staged as three 16-byte records (x y a b |
//     c opacity r g | b invd - -), read back as three float4 broadcasts;
//   - staging double-buffered with cp.async: batch b+1's fields are copied
//     while batch b is replayed, and the sorted owner index is loaded one
//     batch earlier still, so no dependent gather stalls the block.  The
//     (P, 10) field rows are 40 bytes, so the copies are 8 bytes wide (five
//     per instance) and the table needs no padding.
// Each warp sum is a fixed binary tree: a thread's top pixel plus its
// bottom one, then lanes l and l ^ o added at offsets 16, 8, 4, 2, 1 (float
// addition is commutative, so either lane of a pair forms the same sum).
// After each batch, thread j adds the 4 warp partials of instance j in warp
// order and writes its slot.  The plain twin (ops/blend.py::_pixel_sum)
// sums in this order, so the two agree to the bit, and the result is
// deterministic.  The block stops once every pixel is past its NB and
// writes zeros for the rest of its range, so every slot of
// [tile_start, tile_end) is written; slots at or past the stream's valid
// length are never written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int THREADS = PIX / 2;  // two vertically adjacent pixels per thread
constexpr int WARPS = THREADS / 32;
constexpr int NUM_FIELDS = 10;  // x, y, conic a/b/c, opacity, r, g, b, inverse depth
constexpr int OUT_COLS = 8;     // forward output: R, G, B, T, invd, NB, 0, 0
constexpr int CT_COLS = 5;      // cotangent: R, G, B, T, invd
constexpr int NSUM = 10;        // per-pair terms summed over the tile's pixels
constexpr int BATCH = THREADS;  // instances staged per round, one per thread
constexpr int REC = 3;          // float4 records per staged instance
constexpr int PART = NSUM + 1;  // odd row stride: conflict-free stores and reads
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_CAP = 0.99f;
constexpr float POWER_EPS = 1e-4f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy one Gaussian's 40-byte field row into its three 16-byte records.
__device__ __forceinline__ void stage(float4* rec, const float* __restrict__ fields, int g) {
    const float* src = fields + (size_t)g * NUM_FIELDS;
    float* dst = reinterpret_cast<float*>(rec);
#pragma unroll
    for (int k = 0; k < NUM_FIELDS; k += 2) cp_async8(dst + k, src + k);
}

// One level of the reduce-scatter: v[0, M) -> v[0, H), H = ceil(M / 2).
// Lanes with bit O clear keep the low half, lanes with it set the high half
// (where the high half is one short, that lane's last slot is never read).
template <int M, int O>
__device__ __forceinline__ void scatter_level(float (&v)[NSUM], bool hi) {
    if constexpr (M == 1) {
        v[0] = v[0] + __shfl_xor_sync(FULL, v[0], O);
    } else {
        constexpr int H = (M + 1) / 2;
#pragma unroll
        for (int i = 0; i < H; ++i) {
            const float lo = v[i];
            const float up = H + i < M ? v[H + i] : 0.0f;
            v[i] = (hi ? up : lo) + __shfl_xor_sync(FULL, hi ? lo : up, O);
        }
    }
}

// The warp sum of term term_of(lane) lands in lane's v[0].
__device__ __forceinline__ float reduce_scatter(float (&v)[NSUM], int lane) {
    scatter_level<10, 16>(v, lane & 16);
    scatter_level<5, 8>(v, lane & 8);
    scatter_level<3, 4>(v, lane & 4);
    scatter_level<2, 2>(v, lane & 2);
    scatter_level<1, 1>(v, lane & 1);
    return v[0];
}

// The term whose warp sum the reduce-scatter leaves in this lane, or -1:
// bit 4 picks terms 0-4 or 5-9, bits 3..1 pick 0 1 2 - 3 4 - - within them,
// and of each pair of lanes that hold a sum the even one stores it.
__device__ __forceinline__ int term_of(int lane) {
    const int code = (lane >> 1) & 7;
    const int k = code < 3 ? code : (code == 4 || code == 5) ? code - 1 : -1;
    return (lane & 1) || k < 0 ? -1 : k + 5 * (lane >> 4);
}

// One pixel's replay state: its row, cotangent, Ctot_q, NB and the carried
// T and Bq.
struct Pixel {
    float py, dR, dG, dB, dD, Ctot, nb, T, Bq;
};

__device__ __forceinline__ Pixel load_pixel(const float* __restrict__ packed,
                                            const float* __restrict__ ct, size_t pix,
                                            float py) {
    const float* f = packed + pix * OUT_COLS;
    const float* c = ct + pix * CT_COLS;
    Pixel p;
    p.py = py;
    p.dR = c[0];
    p.dG = c[1];
    p.dB = c[2];
    p.dD = c[4];
    p.Ctot = f[0] * c[0] + f[1] * c[1] + f[2] * c[2] + f[4] * c[4] + f[3] * c[3];
    p.nb = f[5];
    p.T = 1.0f;
    p.Bq = 0.0f;
    return p;
}

// The instance's alpha at this pixel; true where the pair contributes.
__device__ __forceinline__ bool replay(const Pixel& p, float dx, float4 r0, float4 r1,
                                       float pos, float& dy, float& raw, float& alpha) {
    dy = r0.y - p.py;
    const float power = -0.5f * (r0.z * dx * dx + r1.x * dy * dy) - r0.w * dx * dy;
    raw = r1.y * expf(power);
    alpha = fminf(ALPHA_CAP, raw);
    return power <= POWER_EPS && alpha >= ALPHA_MIN && pos < p.nb;
}

// A contributing pair's 10 terms; carries T and Bq past the instance.
__device__ __forceinline__ void terms(Pixel& p, float dx, float dy, float raw, float alpha,
                                      float4 r1, float4 r2, float (&v)[NSUM]) {
    const float q = r1.z * p.dR + r1.w * p.dG + r2.x * p.dB + r2.y * p.dD;
    const float w = alpha * p.T;
    const float wq = w * q;
    p.Bq = p.Bq + wq;
    const float gl =
        raw < ALPHA_CAP ? wq - (alpha * (1.0f / (1.0f - alpha))) * (p.Ctot - p.Bq) : 0.0f;
    p.T = p.T * (1.0f - alpha);
    const float gx = gl * dx;
    const float gy = gl * dy;
    v[0] = gl;
    v[1] = gx;
    v[2] = gy;
    v[3] = gx * dx;
    v[4] = gx * dy;
    v[5] = gy * dy;
    v[6] = w * p.dR;
    v[7] = w * p.dG;
    v[8] = w * p.dB;
    v[9] = w * p.dD;
}

__global__ void __launch_bounds__(THREADS) blend_backward_kernel(
    const int32_t* __restrict__ sorted_owner,  // (cap,) Gaussian per sorted position
    const int32_t* __restrict__ tile_starts,   // (num_tiles,)
    const int32_t* __restrict__ tile_ends,     // (num_tiles,)
    const float* __restrict__ fields,          // (P, NUM_FIELDS), rows 8-byte aligned
    const float* __restrict__ packed,          // (num_tiles, PIX, OUT_COLS)
    const float* __restrict__ ct,              // (num_tiles, PIX, CT_COLS)
    int grid_x,
    float* __restrict__ out)                   // (cap, NUM_FIELDS)
{
    __shared__ float4 rec[2][BATCH][REC];
    __shared__ float part[WARPS][BATCH][PART];

    const int tile = blockIdx.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const int term = term_of(lane);
    // warp w covers the 8x8 quarter (w & 1, w >> 1) of the tile; lane l its
    // column l & 7 and rows 2 (l >> 3) and 2 (l >> 3) + 1
    const int col = 8 * (warp & 1) + (lane & 7);
    const int row = 8 * (warp >> 1) + 2 * (lane >> 3);
    const float px = (float)((tile % grid_x) * TILE + col);
    const float py = (float)((tile / grid_x) * TILE + row);
    const size_t p0 = (size_t)tile * PIX + row * TILE + col;
    Pixel top = load_pixel(packed, ct, p0, py);
    Pixel bot = load_pixel(packed, ct, p0 + TILE, py + 1.0f);
    // no lane of this warp contributes at or past the warp's largest NB
    const float warp_nb = __uint_as_float(
        __reduce_max_sync(FULL, __float_as_uint(fmaxf(top.nb, bot.nb))));
    const int start = tile_starts[tile];
    const int end = tile_ends[tile];

    // thread t stages instance t of each batch; ``own`` is its owner in the
    // batch after the one in flight
    if (start + t < end) stage(rec[0][t], fields, sorted_owner[start + t]);
    cp_async_commit();
    int own = start + BATCH + t < end ? sorted_owner[start + BATCH + t] : 0;

    int buf = 0;
    for (int b0 = start; b0 < end; b0 += BATCH, buf ^= 1) {
        // also the barrier that lets the previous batch's reads finish
        const float pos0 = (float)b0;
        if (__syncthreads_count(pos0 >= top.nb && pos0 >= bot.nb) == THREADS) {
            cp_async_wait<0>();
            float* o = out + (size_t)b0 * NUM_FIELDS;
            const int rest = (end - b0) * NUM_FIELDS;
            for (int i = t; i < rest; i += THREADS) o[i] = 0.0f;
            break;
        }
        const int next = b0 + BATCH + t;
        if (next < end) stage(rec[buf ^ 1][t], fields, own);
        cp_async_commit();
        own = next + BATCH < end ? sorted_owner[next + BATCH] : 0;
        cp_async_wait<1>();
        __syncthreads();

        const int n = min(BATCH, end - b0);
        const int live = min(n, max(0, (int)warp_nb - b0));  // positions below warp_nb
        int j = 0;
        for (; j < live; ++j) {
            const float4 r0 = rec[buf][j][0];  // x, y, a, b
            const float4 r1 = rec[buf][j][1];  // c, opacity, r, g
            const float4 r2 = rec[buf][j][2];  // b, invd
            const float dx = r0.x - px;
            const float pos = (float)(b0 + j);
            float dy0, raw0, alpha0, dy1, raw1, alpha1;
            const bool c0 = replay(top, dx, r0, r1, pos, dy0, raw0, alpha0);
            const bool c1 = replay(bot, dx, r0, r1, pos, dy1, raw1, alpha1);
            float sum = 0.0f;
            if (__any_sync(FULL, c0 || c1)) {
                float v[NSUM], u[NSUM];
#pragma unroll
                for (int k = 0; k < NSUM; ++k) v[k] = u[k] = 0.0f;
                if (c0) terms(top, dx, dy0, raw0, alpha0, r1, r2, v);
                if (c1) terms(bot, dx, dy1, raw1, alpha1, r1, r2, u);
#pragma unroll
                for (int k = 0; k < NSUM; ++k) v[k] = v[k] + u[k];
                sum = reduce_scatter(v, lane);
            }
            if (term >= 0) part[warp][j][term] = sum;
        }
        for (; j < n; ++j)
            if (term >= 0) part[warp][j][term] = 0.0f;
        __syncthreads();
        if (t < n) {
            float S[NSUM];
#pragma unroll
            for (int k = 0; k < NSUM; ++k) {
                float a = part[0][t][k];
#pragma unroll
                for (int w = 1; w < WARPS; ++w) a = a + part[w][t][k];
                S[k] = a;
            }
            const float4 r0 = rec[buf][t][0];
            const float4 r1 = rec[buf][t][1];
            const float ca = r0.z, cb = r0.w, cc = r1.x, op = r1.y;
            float* o = out + (size_t)(b0 + t) * NUM_FIELDS;
            o[0] = -(ca * S[1] + cb * S[2]);
            o[1] = -(cc * S[2] + cb * S[1]);
            o[2] = -0.5f * S[3];
            o[3] = -S[4];
            o[4] = -0.5f * S[5];
            o[5] = op > 0.0f ? S[0] * (1.0f / fmaxf(op, 1e-30f)) : 0.0f;
            o[6] = S[6];
            o[7] = S[7];
            o[8] = S[8];
            o[9] = S[9];
        }
    }
    cp_async_wait<0>();  // leave no copy in flight
}

}  // namespace

extern "C" {

const char* gs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int gs_blend_backward(const void* sorted_owner, const void* tile_starts,
                      const void* tile_ends, const void* fields,
                      const void* packed, const void* ct, int num_tiles,
                      int grid_x, void* out, void* stream) {
    if (num_tiles <= 0) return 0;
    blend_backward_kernel<<<num_tiles, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)sorted_owner, (const int32_t*)tile_starts,
        (const int32_t*)tile_ends, (const float*)fields, (const float*)packed,
        (const float*)ct, grid_x, (float*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
