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
// What bounds it on the card: operations.  Every (pixel, instance) pair the
// forward visited is replayed (17 float operations, one an expf, to form
// alpha and test it), and a contributing pair adds 27 more for its gradient
// terms and 10 into the instance's sums over the tile's 256 pixels
// (chip_smoke.py counts both kinds of pair on its inputs).  Design: one block per tile, one thread per
// pixel, instances staged BATCH at a time in shared memory as in K2.  Each
// warp reduces an instance's 10 terms with a shuffle tree (skipped, with
// zeros written, when no lane of the warp contributes); the 8 warp partials
// land in shared memory and, after the batch, thread j adds them in warp
// order for instance j and writes its slot.  The order of every sum is
// fixed, so the result is deterministic, and the plain twin
// (ops/blend.py::blend_backward_plain) repeats it to the bit.  The block
// stops once every pixel is past its NB and writes zeros for the rest of
// its range, so every slot of [tile_start, tile_end) is written; slots at
// or past the stream's valid length are never written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int PIX = TILE * TILE;
constexpr int WARPS = PIX / 32;
constexpr int NUM_FIELDS = 10;  // x, y, conic a/b/c, opacity, r, g, b, inverse depth
constexpr int OUT_COLS = 8;     // forward output: R, G, B, T, invd, NB, 0, 0
constexpr int CT_COLS = 5;      // cotangent: R, G, B, T, invd
constexpr int NSUM = 10;        // per-pair terms summed over the tile's pixels
constexpr int BATCH = 128;      // instances staged per round (45 KB of shared memory)
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_CAP = 0.99f;
constexpr float POWER_EPS = 1e-4f;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(PIX) blend_backward_kernel(
    const int32_t* __restrict__ sorted_owner,  // (cap,) Gaussian per sorted position
    const int32_t* __restrict__ tile_starts,   // (num_tiles,)
    const int32_t* __restrict__ tile_ends,     // (num_tiles,)
    const float* __restrict__ fields,          // (P, NUM_FIELDS)
    const float* __restrict__ packed,          // (num_tiles, PIX, OUT_COLS)
    const float* __restrict__ ct,              // (num_tiles, PIX, CT_COLS)
    int grid_x,
    float* __restrict__ out)                   // (cap, NUM_FIELDS)
{
    __shared__ float s[NUM_FIELDS][BATCH];
    __shared__ float part[WARPS][NSUM][BATCH];

    const int tile = blockIdx.x;
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const float px = (float)((tile % grid_x) * TILE + (t % TILE));
    const float py = (float)((tile / grid_x) * TILE + (t / TILE));
    const int start = tile_starts[tile];
    const int end = tile_ends[tile];

    const float* f = packed + ((size_t)tile * PIX + t) * OUT_COLS;
    const float* c = ct + ((size_t)tile * PIX + t) * CT_COLS;
    const float dR = c[0], dG = c[1], dB = c[2], dT = c[3], dD = c[4];
    const float Ctot = f[0] * dR + f[1] * dG + f[2] * dB + f[4] * dD + f[3] * dT;
    const float nb = f[5];

    float T = 1.0f, Bq = 0.0f;
    for (int b0 = start; b0 < end; b0 += BATCH) {
        // also the barrier that lets the previous batch's reads finish
        if (__syncthreads_count((float)b0 >= nb) == PIX) {
            float* o = out + (size_t)b0 * NUM_FIELDS;
            const int rest = (end - b0) * NUM_FIELDS;
            for (int i = t; i < rest; i += PIX) o[i] = 0.0f;
            break;
        }
        const int n = min(BATCH, end - b0);
        if (t < n) {
            const float* g = fields + (size_t)sorted_owner[b0 + t] * NUM_FIELDS;
#pragma unroll
            for (int k = 0; k < NUM_FIELDS; ++k) s[k][t] = g[k];
        }
        __syncthreads();
        for (int j = 0; j < n; ++j) {
            const float dx = s[0][j] - px;
            const float dy = s[1][j] - py;
            const float power =
                -0.5f * (s[2][j] * dx * dx + s[4][j] * dy * dy) - s[3][j] * dx * dy;
            const float raw = s[5][j] * expf(power);
            const float alpha = fminf(ALPHA_CAP, raw);
            const bool contrib = power <= POWER_EPS && alpha >= ALPHA_MIN &&
                                 (float)(b0 + j) < nb;
            float v[NSUM];
#pragma unroll
            for (int k = 0; k < NSUM; ++k) v[k] = 0.0f;
            if (contrib) {
                const float q = s[6][j] * dR + s[7][j] * dG + s[8][j] * dB + s[9][j] * dD;
                const float w = alpha * T;
                const float wq = w * q;
                Bq = Bq + wq;
                const float gl = raw < ALPHA_CAP
                                     ? wq - (alpha * (1.0f / (1.0f - alpha))) * (Ctot - Bq)
                                     : 0.0f;
                T = T * (1.0f - alpha);
                const float gx = gl * dx;
                const float gy = gl * dy;
                v[0] = gl;
                v[1] = gx;
                v[2] = gy;
                v[3] = gx * dx;
                v[4] = gx * dy;
                v[5] = gy * dy;
                v[6] = w * dR;
                v[7] = w * dG;
                v[8] = w * dB;
                v[9] = w * dD;
            }
            if (__any_sync(FULL, contrib)) {
#pragma unroll
                for (int k = 0; k < NSUM; ++k) {
#pragma unroll
                    for (int off = 16; off > 0; off >>= 1)
                        v[k] = v[k] + __shfl_down_sync(FULL, v[k], off);
                }
            }
            if (lane == 0) {
#pragma unroll
                for (int k = 0; k < NSUM; ++k) part[warp][k][j] = v[k];
            }
        }
        __syncthreads();
        if (t < n) {
            float S[NSUM];
#pragma unroll
            for (int k = 0; k < NSUM; ++k) {
                float a = part[0][k][t];
#pragma unroll
                for (int w = 1; w < WARPS; ++w) a = a + part[w][k][t];
                S[k] = a;
            }
            const float ca = s[2][t], cb = s[3][t], cc = s[4][t], op = s[5][t];
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
    blend_backward_kernel<<<num_tiles, PIX, 0, (cudaStream_t)stream>>>(
        (const int32_t*)sorted_owner, (const int32_t*)tile_starts,
        (const int32_t*)tile_ends, (const float*)fields, (const float*)packed,
        (const float*)ct, grid_x, (float*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
