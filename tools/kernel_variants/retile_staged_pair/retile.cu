// K4 retile, variant: like tools/kernel_variants/retile_staged (records
// transposed through shared memory, stored as float4 lines) with a block
// per pair of horizontally adjacent tiles, so that each plane row is read as
// one 128-byte run and the block stores the pair's 2 tile_h tile_w C
// contiguous floats.  gaussian_splatting_torch/csrc/retile.cu is this design
// with every plane of a pixel loaded into registers before the first
// shared-memory store; here each load is stored as it arrives.  Same C
// interface and result.  Takes tile_w * tile_h <= 512.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 2;  // tiles per block along x

__global__ void retile_kernel(
    const float* __restrict__ img,  // (cols, height, width)
    int cols, int grid_x, int tile_w, int tile_h, int height, int width,
    float* __restrict__ out)        // (num_tiles, tile_h * tile_w, cols)
{
    extern __shared__ float4 s_tile4[];
    float* s_tile = reinterpret_cast<float*>(s_tile4);
    const int pairs_x = (grid_x + TX - 1) / TX;
    const int ty = blockIdx.x / pairs_x;
    const int tx0 = (blockIdx.x - ty * pairs_x) * TX;
    const int n_tiles = min(TX, grid_x - tx0);
    const int pix = tile_w * tile_h;
    const int64_t plane = (int64_t)height * width;
    // thread (threadIdx.x, threadIdx.y): column threadIdx.x of the pair's
    // TX tile_w columns, row threadIdx.y
    const int px = threadIdx.x, py = threadIdx.y;
    const int k = px / tile_w;  // the tile of the pair
    if (k < n_tiles) {
        const int y = ty * tile_h + py, x = tx0 * tile_w + px;
        float* dst = s_tile + (k * pix + py * tile_w + (px - k * tile_w)) * cols;
        if (y < height && x < width) {
            const float* src = img + (int64_t)y * width + x;
#pragma unroll 4
            for (int c = 0; c < cols; ++c) dst[c] = __ldg(src + c * plane);
        } else {
            for (int c = 0; c < cols; ++c) dst[c] = 0.0f;
        }
    }
    __syncthreads();
    const int nf = n_tiles * pix * cols;
    float* rec0 = out + ((int64_t)ty * grid_x + tx0) * pix * cols;
    const int t = threadIdx.y * blockDim.x + threadIdx.x, nt = blockDim.x * blockDim.y;
    if ((nf & 3) == 0 && ((uintptr_t)rec0 & 15) == 0) {
        float4* d4 = reinterpret_cast<float4*>(rec0);
        for (int q = t; q < nf / 4; q += nt) d4[q] = s_tile4[q];
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
    if (grid_x <= 0 || grid_y <= 0 || tile_w <= 0 || tile_h <= 0 || cols <= 0) return 0;
    if (TX * tile_w * tile_h > 1024) return (int)cudaErrorInvalidValue;
    const int blocks = (grid_x + TX - 1) / TX * grid_y;
    const size_t smem = (size_t)TX * tile_w * tile_h * cols * sizeof(float);
    retile_kernel<<<blocks, dim3(TX * tile_w, tile_h), smem, (cudaStream_t)stream>>>(
        (const float*)img, cols, grid_x, tile_w, tile_h, height, width, (float*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
