// K4 retile, variant (b): the records of a tile transposed through shared
// memory and stored as float4 lines, a block per tile.  Same C interface and
// result as gaussian_splatting_torch/csrc/retile.cu (which takes a pair of
// tiles per block and loads a pixel's planes into registers first); variant
// (a), one thread per record storing from registers, is
// tools/kernel_variants/retile_records.  tools/torch_layout_ab.py times them
// (PERF.md).
//
// One block per tile, a thread per pixel.  Each thread reads its pixel's C
// planes into the tile's records in shared memory (stride C words), then the
// block stores the tile's tile_h * tile_w * C contiguous floats as float4s
// (scalars when that count or the tile's base is not 16-byte aligned).
// Needs tile_w * tile_h * C * 4 bytes of shared memory: the wrapper's shapes
// (16 x 16 tiles, C <= 8) take at most 8 KB.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void retile_kernel(
    const float* __restrict__ img,  // (cols, height, width)
    int cols, int grid_x, int tile_w, int tile_h, int height, int width,
    float* __restrict__ out)        // (num_tiles, tile_h * tile_w, cols)
{
    extern __shared__ float4 s_tile4[];
    float* s_tile = reinterpret_cast<float*>(s_tile4);
    const int tile = blockIdx.x;
    const int ty = tile / grid_x;
    const int y0 = ty * tile_h, x0 = (tile - ty * grid_x) * tile_w;
    const int64_t plane = (int64_t)height * width;
    for (int py = threadIdx.y; py < tile_h; py += blockDim.y) {
        for (int px = threadIdx.x; px < tile_w; px += blockDim.x) {
            const int y = y0 + py, x = x0 + px;
            float* dst = s_tile + (py * tile_w + px) * cols;
            if (y < height && x < width) {
                const float* src = img + (int64_t)y * width + x;
#pragma unroll 4
                for (int c = 0; c < cols; ++c) dst[c] = __ldg(src + c * plane);
            } else {
                for (int c = 0; c < cols; ++c) dst[c] = 0.0f;
            }
        }
    }
    __syncthreads();
    const int nf = tile_w * tile_h * cols;
    float* rec0 = out + (int64_t)tile * nf;
    const int t = threadIdx.y * blockDim.x + threadIdx.x, nt = blockDim.x * blockDim.y;
    if ((nf & 3) == 0 && ((uintptr_t)rec0 & 15) == 0) {
        float4* dst = reinterpret_cast<float4*>(rec0);
        for (int q = t; q < nf / 4; q += nt) dst[q] = s_tile4[q];
    } else {
        for (int q = t; q < nf; q += nt) rec0[q] = s_tile[q];
    }
}

}  // namespace

extern "C" {

const char* gs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int gs_retile(const void* img, int cols, int grid_x, int grid_y, int tile_w,
              int tile_h, int height, int width, void* out, void* stream) {
    const int64_t tiles = (int64_t)grid_x * grid_y;
    if (tiles <= 0 || tile_w <= 0 || tile_h <= 0 || cols <= 0) return 0;
    const int bx = tile_w < 1024 ? tile_w : 1024;
    const int by = tile_h < 1024 / bx ? tile_h : 1024 / bx;
    const size_t smem = (size_t)tile_w * tile_h * cols * sizeof(float);
    retile_kernel<<<(unsigned)tiles, dim3(bx, by), smem, (cudaStream_t)stream>>>(
        (const float*)img, cols, grid_x, tile_w, tile_h, height, width, (float*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
