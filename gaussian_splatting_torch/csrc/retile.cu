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
// write of every output value; no arithmetic).  Design: one thread per
// output element, in output order, so every warp's 32 stores are one
// coalesced 128-byte line; neighbouring threads read the C planes of one
// pixel, then the next pixel of the same tile row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void retile_kernel(
    const float* __restrict__ img,  // (cols, height, width)
    int cols, int grid_x, int tile_w, int tile_h, int height, int width,
    int64_t n,
    float* __restrict__ out)        // (num_tiles, tile_h * tile_w, cols)
{
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int pix = tile_w * tile_h;
    const int64_t rec = i / cols;  // tile * pix + p
    const int c = (int)(i - rec * cols);
    const int tile = (int)(rec / pix);
    const int p = (int)(rec - (int64_t)tile * pix);
    const int y = (tile / grid_x) * tile_h + p / tile_w;
    const int x = (tile % grid_x) * tile_w + p % tile_w;
    out[i] = (y < height && x < width)
                 ? img[((int64_t)c * height + y) * width + x]
                 : 0.0f;
}

}  // namespace

extern "C" {

const char* gs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int gs_retile(const void* img, int cols, int grid_x, int grid_y, int tile_w,
              int tile_h, int height, int width, void* out, void* stream) {
    const int64_t n = (int64_t)grid_x * grid_y * tile_w * tile_h * cols;
    if (n <= 0) return 0;
    const int threads = 256;
    const int64_t blocks = (n + threads - 1) / threads;
    retile_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)img, cols, grid_x, tile_w, tile_h, height, width, n,
        (float*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
