// K4 retile: image planes (C, H, W) -> packed per-tile records
// (num_tiles, tile_h*tile_w, C), with zeros for the padding pixels outside
// (H, W).  The untile's backward: the mirror of csrc/untile.cu, which crops
// inside its kernel, so this one pads inside its kernel.
//
// Replaces gaussian_splatting_tpu/ops/untile.py::_retile_raw
// (_retile_kernel behind untile_pallas.defvjp), which relaid one row of tiles
// per grid step in vector registers from an already padded image.
//
// What bounds it on the card: bytes (one read of every image value, one
// write of every output value; no arithmetic).  A design that came first ran
// one thread per output value: two 64-bit and four 32-bit divisions by
// runtime values to move 4 bytes, and a warp's 32 values were 6.4 pixels of
// 5 planes, so each 128-byte store pulled partly used sectors from 5 planes.
//
// Design: one thread per output record, a block per pair of horizontally
// adjacent tiles (TX tiles), so the only division left is the block's by
// the pairs in a tile row.  A warp's 32 threads are one 32-pixel row of the
// pair: each plane row is read as one 128-byte run of whole sectors.  Each
// thread loads its pixel's C planes into registers, all loads issued before
// the first store, and writes its record into the pair's records in shared
// memory; the block then stores the pair's TX tile_h tile_w C contiguous
// floats as float4 lines.  Records of padding pixels get zeros and read
// nothing.  Measured against one thread
// per record storing from registers, a block per single tile, and four tiles
// per block (tools/kernel_variants/retile_*; PERF.md).  Shapes the
// path never gives (a pair of tiles over 1024 pixels, or its records over
// 48 KB of shared memory) take retile_direct_kernel, whose threads store
// their records straight to device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 2;          // tiles per block along x (a pair)
constexpr int MAX_COLS = 8;    // record widths loaded into registers at once
constexpr int SMEM_MAX = 48 * 1024;

// The path's kernel: a block of (TX tile_w, tile_h) threads per pair, the
// pair's records staged in shared memory, then stored as float4 lines.
__global__ void retile_kernel(
    const float* __restrict__ img,  // (cols, height, width)
    int cols, int grid_x, int tile_w, int tile_h, int height, int width,
    float* __restrict__ out)        // (num_tiles, tile_h * tile_w, cols)
{
    extern __shared__ float4 s_pair4[];
    float* s_pair = reinterpret_cast<float*>(s_pair4);
    const int blocks_x = (grid_x + TX - 1) / TX;
    const int ty = blockIdx.x / blocks_x;
    const int tx0 = (blockIdx.x - ty * blocks_x) * TX;
    const int n_tiles = min(TX, grid_x - tx0);  // 1 at the end of an odd tile row
    const int pix = tile_w * tile_h;
    const int64_t plane = (int64_t)height * width;
    const int px = threadIdx.x, py = threadIdx.y;
    const int k = px / tile_w;  // the tile of the pair
    if (k < n_tiles) {
        const int y = ty * tile_h + py, x = tx0 * tile_w + px;
        float* dst = s_pair + (k * pix + py * tile_w + (px - k * tile_w)) * cols;
        if (y < height && x < width) {
            const float* src = img + (int64_t)y * width + x;
            if (cols <= MAX_COLS) {  // every load issued before the first store
                float v[MAX_COLS];
#pragma unroll
                for (int c = 0; c < MAX_COLS; ++c) v[c] = c < cols ? __ldg(src + c * plane) : 0.0f;
#pragma unroll
                for (int c = 0; c < MAX_COLS; ++c)
                    if (c < cols) dst[c] = v[c];
            } else {
                for (int c = 0; c < cols; ++c) dst[c] = __ldg(src + c * plane);
            }
        } else {
            for (int c = 0; c < cols; ++c) dst[c] = 0.0f;
        }
    }
    __syncthreads();
    const int nf = n_tiles * pix * cols;
    float* rec0 = out + ((int64_t)ty * grid_x + tx0) * pix * cols;
    const int t = py * blockDim.x + px, nt = blockDim.x * blockDim.y;
    if ((nf & 3) == 0 && ((uintptr_t)rec0 & 15) == 0) {
        float4* d4 = reinterpret_cast<float4*>(rec0);
        for (int q = t; q < nf / 4; q += nt) d4[q] = s_pair4[q];
    } else {
        for (int q = t; q < nf; q += nt) rec0[q] = s_pair[q];
    }
}

// Shapes the path never gives (a pair of tiles over 1024 pixels, or its
// records over 48 KB): one thread per record of one tile, looping over the
// tile, each record stored straight to device memory.
__global__ void retile_direct_kernel(
    const float* __restrict__ img, int cols, int grid_x, int tile_w, int tile_h,
    int height, int width, float* __restrict__ out)
{
    const int tile = blockIdx.x;
    const int ty = tile / grid_x;
    const int y0 = ty * tile_h, x0 = (tile - ty * grid_x) * tile_w;
    float* rec0 = out + (int64_t)tile * tile_w * tile_h * cols;
    const int64_t plane = (int64_t)height * width;
    for (int py = threadIdx.y; py < tile_h; py += blockDim.y) {
        for (int px = threadIdx.x; px < tile_w; px += blockDim.x) {
            const int y = y0 + py, x = x0 + px;
            float* dst = rec0 + (int64_t)(py * tile_w + px) * cols;
            const bool in = y < height && x < width;
            for (int c = 0; c < cols; ++c)
                dst[c] = in ? __ldg(img + c * plane + (int64_t)y * width + x) : 0.0f;
        }
    }
}

}  // namespace

extern "C" {

const char* gs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int gs_retile(const void* img, int cols, int grid_x, int grid_y, int tile_w,
              int tile_h, int height, int width, void* out, void* stream) {
    if (grid_x <= 0 || grid_y <= 0 || tile_w <= 0 || tile_h <= 0 || cols <= 0) return 0;
    const int64_t smem = (int64_t)TX * tile_w * tile_h * cols * (int64_t)sizeof(float);
    if ((int64_t)TX * tile_w * tile_h <= 1024 && smem <= SMEM_MAX) {
        const int64_t blocks = (int64_t)((grid_x + TX - 1) / TX) * grid_y;
        retile_kernel<<<(unsigned)blocks, dim3(TX * tile_w, tile_h), (size_t)smem,
                        (cudaStream_t)stream>>>(
            (const float*)img, cols, grid_x, tile_w, tile_h, height, width, (float*)out);
    } else {
        const int bx = tile_w < 1024 ? tile_w : 1024;
        const int by = tile_h < 1024 / bx ? tile_h : 1024 / bx;
        retile_direct_kernel<<<(unsigned)((int64_t)grid_x * grid_y), dim3(bx, by), 0,
                               (cudaStream_t)stream>>>(
            (const float*)img, cols, grid_x, tile_w, tile_h, height, width, (float*)out);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
