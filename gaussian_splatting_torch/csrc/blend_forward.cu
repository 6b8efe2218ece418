// K2 blend forward: front-to-back alpha blending of every 16x16 tile over
// its sorted instance range, into packed (num_tiles, 256, 8) records
// R, G, B, T, inverse depth, NB, 0, 0.
//
// Replaces gaussian_splatting_tpu/ops/blend_pallas.py::blend_forward_pallas
// (_forward_kernel, _forward_one_tile, _chunk_alpha).  The TPU version
// vectorised each tile over (256 pixels x chunk instances) with a log/exp
// prefix product for the transmittance; on the GPU each pixel is a thread
// that walks its tile's instances in order, as the reference renderer does.
//
// Per instance (semantics of blend_pallas.py:204-271 and 383-446):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,  dx = mean_x - px (integer px)
//   alpha = min(0.99, opacity * exp(power))
//   eligible iff power <= POWER_EPS and alpha >= 1/255
//   test_T = T (1 - alpha); if test_T < T_EPS the pixel is done and NB is
//   this instance's absolute position in the sorted stream (the backward's
//   contributor set is "eligible and position < NB"); else the pixel adds
//   alpha T times its colour and inverse depth, and T = test_T.
//
// Layout: one block per tile, one thread per pixel; the block stages BATCH
// instances at a time in shared memory and every thread reads them back as
// broadcasts.  A warp-step (one instance against a warp's 32 pixels) costs
// 16 float operations per pixel (one a precise expf; the build contracts no
// multiply-add, so the kernel rounds like its plain twin), 12 more on a
// contributing pixel (chip_smoke.py counts both kinds of pair), against
// ~44 bytes read per instance and 32 bytes written per pixel.
//
// What bounds it on this card: instruction issue and the block-wide stall
// at each batch.  Ten scalar shared-memory reads per warp-step, or a
// staging round that gathers the fields through the sorted owner index
// (two dependent global loads) behind a barrier with nothing else in
// flight, would cost about as much as the arithmetic.  The design:
//   - each instance's 10 fields staged as three 16-byte records (x y a b |
//     c opacity r g | b invd - -), read back as three float4 broadcasts;
//   - staging double-buffered with cp.async: batch b+1's fields are copied
//     while batch b is blended, and the sorted owner index is loaded one
//     batch earlier still.  The (P, 10) field rows are 40 bytes, so the
//     copies are 8 bytes wide (five per instance) and the table needs no
//     padding.
// A thread stops at its NB; the block leaves as soon as
// __syncthreads_count says all 256 pixels are done, so saturated tiles stop
// early, and each tile's work is independent (no atomics).  Two pixels per
// thread (K5's layout) ran slower here, 0.636 ms against 0.545 on the bench
// scene's inputs (tools/torch_blend_ab.py on an H100 80GB HBM3 at 700 W): a
// thread then walks until both of its pixels are done, and each pixel's
// early-out branch diverges on its own.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int NUM_FIELDS = 10;  // x, y, conic a/b/c, opacity, r, g, b, inverse depth
constexpr int OUT_COLS = 8;
constexpr int BATCH = PIX;      // instances staged per round, one per thread
constexpr int REC = 3;          // float4 records per staged instance
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_CAP = 0.99f;
constexpr float T_EPS = 1e-4f;
constexpr float POWER_EPS = 1e-4f;
constexpr float NB_BIG = 16777216.0f;  // 2^24: never done

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

__global__ void __launch_bounds__(PIX) blend_forward_kernel(
    const int32_t* __restrict__ sorted_owner,  // (cap,) Gaussian per sorted position
    const int32_t* __restrict__ tile_starts,   // (num_tiles,)
    const int32_t* __restrict__ tile_ends,     // (num_tiles,)
    const float* __restrict__ fields,          // (P, NUM_FIELDS), rows 8-byte aligned
    int grid_x,
    float* __restrict__ out)                   // (num_tiles, PIX, OUT_COLS)
{
    __shared__ float4 rec[2][BATCH][REC];

    const int tile = blockIdx.x;
    const int t = threadIdx.x;
    const float px = (float)((tile % grid_x) * TILE + (t % TILE));
    const float py = (float)((tile / grid_x) * TILE + (t / TILE));
    const int start = tile_starts[tile];
    const int end = tile_ends[tile];

    // thread t stages instance t of each batch; ``own`` is its owner in the
    // batch after the one in flight
    if (start + t < end) stage(rec[0][t], fields, sorted_owner[start + t]);
    cp_async_commit();
    int own = start + BATCH + t < end ? sorted_owner[start + BATCH + t] : 0;

    float T = 1.0f, R = 0.0f, G = 0.0f, B = 0.0f, D = 0.0f;
    float nb = NB_BIG;
    int done = 0;
    int buf = 0;
    for (int b0 = start; b0 < end; b0 += BATCH, buf ^= 1) {
        // also the barrier that lets the previous batch's reads finish
        if (__syncthreads_count(done) == PIX) break;
        const int next = b0 + BATCH + t;
        if (next < end) stage(rec[buf ^ 1][t], fields, own);
        cp_async_commit();
        own = next + BATCH < end ? sorted_owner[next + BATCH] : 0;
        cp_async_wait<1>();
        __syncthreads();

        const int n = min(BATCH, end - b0);
        for (int j = 0; j < n && !done; ++j) {
            const float4 r0 = rec[buf][j][0];  // x, y, a, b
            const float4 r1 = rec[buf][j][1];  // c, opacity, r, g
            const float dx = r0.x - px;
            const float dy = r0.y - py;
            const float power = -0.5f * (r0.z * dx * dx + r1.x * dy * dy) - r0.w * dx * dy;
            const float alpha = fminf(ALPHA_CAP, r1.y * expf(power));
            if (!(power <= POWER_EPS && alpha >= ALPHA_MIN)) continue;
            const float test_T = T * (1.0f - alpha);
            if (test_T < T_EPS) {
                nb = (float)(b0 + j);
                done = 1;
                break;
            }
            const float4 r2 = rec[buf][j][2];  // b, invd
            const float w = alpha * T;
            R = R + w * r1.z;
            G = G + w * r1.w;
            B = B + w * r2.x;
            D = D + w * r2.y;
            T = test_T;
        }
    }
    cp_async_wait<0>();  // leave no copy in flight

    float* o = out + ((size_t)tile * PIX + t) * OUT_COLS;
    o[0] = R;
    o[1] = G;
    o[2] = B;
    o[3] = T;
    o[4] = D;
    o[5] = nb;
    o[6] = 0.0f;
    o[7] = 0.0f;
}

}  // namespace

extern "C" {

const char* gs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int gs_blend_forward(const void* sorted_owner, const void* tile_starts,
                     const void* tile_ends, const void* fields, int num_tiles,
                     int grid_x, void* out, void* stream) {
    if (num_tiles <= 0) return 0;
    blend_forward_kernel<<<num_tiles, PIX, 0, (cudaStream_t)stream>>>(
        (const int32_t*)sorted_owner, (const int32_t*)tile_starts,
        (const int32_t*)tile_ends, (const float*)fields, grid_x, (float*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
