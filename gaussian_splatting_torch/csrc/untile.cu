// K3 untile: packed per-tile records (num_tiles, tile_h*tile_w, cols_in) ->
// image planes (cols_out, H, W), cropped to the image inside the kernel.
//
// Replaces gaussian_splatting_tpu/ops/untile.py::untile_pallas (_untile_raw,
// _untile_kernel), which relaid one row of tiles per grid step in vector
// registers and left the crop to its caller.
//
// What bounds it on the card: bytes (one read and one write of every output
// value; no arithmetic).  Design: one thread per output element, in output
// order, so every warp's 32 stores are one coalesced 128-byte line.  Each
// thread reads element [tile, (y % th) * tw + x % tw, c]; neighbouring
// threads read neighbouring pixels of one tile row, cols_in floats apart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void untile_kernel(
    const float* __restrict__ packed,  // (num_tiles, tile_h * tile_w, cols_in)
    int cols_in, int cols_out, int grid_x, int tile_w, int tile_h,
    int height, int width,
    float* __restrict__ out)           // (cols_out, height, width)
{
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t plane = (int64_t)height * width;
    if (i >= plane * cols_out) return;
    const int c = (int)(i / plane);
    const int rem = (int)(i - (int64_t)c * plane);
    const int y = rem / width;
    const int x = rem - y * width;
    const int tile = (y / tile_h) * grid_x + x / tile_w;
    const int p = (y % tile_h) * tile_w + x % tile_w;
    out[i] = packed[((int64_t)tile * (tile_h * tile_w) + p) * cols_in + c];
}

}  // namespace

extern "C" {

const char* gs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int gs_untile(const void* packed, int cols_in, int cols_out, int grid_x,
              int tile_w, int tile_h, int height, int width, void* out,
              void* stream) {
    const int64_t n = (int64_t)cols_out * height * width;
    if (n <= 0) return 0;
    const int threads = 256;
    const int64_t blocks = (n + threads - 1) / threads;
    untile_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)packed, cols_in, cols_out, grid_x, tile_w, tile_h, height,
        width, (float*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
