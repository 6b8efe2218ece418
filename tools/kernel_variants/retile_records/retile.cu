// K4 retile, variant (a): one thread per output record, its C values
// stored from registers (a warp's C stores cover its 32 C contiguous floats
// whole).  Same C interface and result as gaussian_splatting_torch/csrc/
// retile.cu, which stages the records of a pair of tiles in shared memory
// and stores them as float4 lines; tools/torch_layout_ab.py times the two
// (PERF.md).  One block per tile, a thread per pixel of it, so the
// only division left is the tile's by grid_x; padding records get zeros and
// read nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void retile_kernel(
    const float* __restrict__ img,  // (cols, height, width)
    int cols, int grid_x, int tile_w, int tile_h, int height, int width,
    float* __restrict__ out)        // (num_tiles, tile_h * tile_w, cols)
{
    const int tile = blockIdx.x;
    const int ty = tile / grid_x;
    const int y0 = ty * tile_h, x0 = (tile - ty * grid_x) * tile_w;
    const int64_t plane = (int64_t)height * width;
    float* rec0 = out + (int64_t)tile * tile_w * tile_h * cols;
    for (int py = threadIdx.y; py < tile_h; py += blockDim.y) {
        for (int px = threadIdx.x; px < tile_w; px += blockDim.x) {
            const int y = y0 + py, x = x0 + px;
            float* dst = rec0 + (int64_t)(py * tile_w + px) * cols;
            if (y < height && x < width) {
                const float* src = img + (int64_t)y * width + x;
#pragma unroll 4
                for (int c = 0; c < cols; ++c) dst[c] = __ldg(src + c * plane);
            } else {
                for (int c = 0; c < cols; ++c) dst[c] = 0.0f;
            }
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
    const int64_t tiles = (int64_t)grid_x * grid_y;
    if (tiles <= 0 || tile_w <= 0 || tile_h <= 0 || cols <= 0) return 0;
    const int bx = tile_w < 1024 ? tile_w : 1024;
    const int by = tile_h < 1024 / bx ? tile_h : 1024 / bx;
    retile_kernel<<<(unsigned)tiles, dim3(bx, by), 0, (cudaStream_t)stream>>>(
        (const float*)img, cols, grid_x, tile_w, tile_h, height, width, (float*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
