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
// What bounds it on the card: operations.  16 float operations (one an
// expf) per (pixel, instance) pair visited, 12 more on a contributing pair
// (chip_smoke.py counts both kinds of pair), against ~44 bytes read per
// instance (owner index + 10 fields, shared by the tile's 256 pixels) and
// 32 bytes written per pixel.  Design: one block per tile, one thread per
// pixel; the block stages 256 instances at a time into shared memory (each
// thread gathers one instance's fields through the sorted owner index) and
// every thread reads them back as broadcasts.  The block leaves as soon as
// __syncthreads_count says all 256 pixels are done, so saturated tiles stop
// early, and each tile's work is independent (no atomics).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int NUM_FIELDS = 10;  // x, y, conic a/b/c, opacity, r, g, b, inverse depth
constexpr int OUT_COLS = 8;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_CAP = 0.99f;
constexpr float T_EPS = 1e-4f;
constexpr float POWER_EPS = 1e-4f;
constexpr float NB_BIG = 16777216.0f;  // 2^24: never done

__global__ void __launch_bounds__(PIX) blend_forward_kernel(
    const int32_t* __restrict__ sorted_owner,  // (cap,) Gaussian per sorted position
    const int32_t* __restrict__ tile_starts,   // (num_tiles,)
    const int32_t* __restrict__ tile_ends,     // (num_tiles,)
    const float* __restrict__ fields,          // (P, NUM_FIELDS)
    int grid_x,
    float* __restrict__ out)                   // (num_tiles, PIX, OUT_COLS)
{
    __shared__ float s[NUM_FIELDS][PIX];

    const int tile = blockIdx.x;
    const int t = threadIdx.x;
    const float px = (float)((tile % grid_x) * TILE + (t % TILE));
    const float py = (float)((tile / grid_x) * TILE + (t / TILE));
    const int start = tile_starts[tile];
    const int end = tile_ends[tile];

    float T = 1.0f, R = 0.0f, G = 0.0f, B = 0.0f, D = 0.0f;
    float nb = NB_BIG;
    int done = 0;

    for (int b0 = start; b0 < end; b0 += PIX) {
        // also the barrier that lets the previous batch's reads finish
        if (__syncthreads_count(done) == PIX) break;
        const int pos = b0 + t;
        if (pos < end) {
            const float* f = fields + (size_t)sorted_owner[pos] * NUM_FIELDS;
#pragma unroll
            for (int k = 0; k < NUM_FIELDS; ++k) s[k][t] = f[k];
        }
        __syncthreads();
        const int n = min(PIX, end - b0);
        for (int j = 0; j < n && !done; ++j) {
            const float dx = s[0][j] - px;
            const float dy = s[1][j] - py;
            const float power =
                -0.5f * (s[2][j] * dx * dx + s[4][j] * dy * dy) - s[3][j] * dx * dy;
            const float alpha = fminf(ALPHA_CAP, s[5][j] * expf(power));
            if (!(power <= POWER_EPS && alpha >= ALPHA_MIN)) continue;
            const float test_T = T * (1.0f - alpha);
            if (test_T < T_EPS) {
                nb = (float)(b0 + j);
                done = 1;
                break;
            }
            const float w = alpha * T;
            R = R + w * s[6][j];
            G = G + w * s[7][j];
            B = B + w * s[8][j];
            D = D + w * s[9][j];
            T = test_T;
        }
    }

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
