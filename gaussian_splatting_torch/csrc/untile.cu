// K3 untile: packed per-tile records (num_tiles, tile_h*tile_w, row floats
// each, the first cols of which are wanted) -> image planes (cols, H, W),
// cropped to the image inside the kernel.
//
// Replaces gaussian_splatting_tpu/ops/untile.py::untile_pallas (_untile_raw,
// _untile_kernel), which relaid one row of tiles per grid step in vector
// registers and left the crop to its caller.
//
// What bounds it on the card: bytes, and which of them are moved.  Each
// pixel record is 32 bytes on the render and train paths (8 floats, of
// which 5 are wanted), one whole sector; the packed block at 1080p is
// 66.8 MB, more than the 50 MB L2.  A design that came first ran one thread
// per *output* value, plane by plane: every plane then streamed the whole
// block from device memory again, 3.5x the bytes needed.  Design: one thread
// per *input* record, walking the block in order.  A thread reads the cols
// values of its record (float4 loads where the record stride allows), so a
// warp reads 32 consecutive records, every sector once, and writes each
// plane straight from registers: a warp's 32 pixels are two 16-pixel rows
// of one tile, two 64-byte runs per plane, whole sectors.  Records of the
// pixels outside (H, W) are neither read nor written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void untile_kernel(
    const float* __restrict__ packed,  // (num_tiles, tile_h * tile_w, row)
    int row, int cols, int grid_x, int tile_w, int tile_h,
    int height, int width,
    float* __restrict__ out)           // (cols, height, width)
{
    const int pix = tile_w * tile_h;
    const int64_t rec = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int tile = (int)(rec / pix);
    const int p = (int)(rec - (int64_t)tile * pix);
    const int ty = tile / grid_x;
    const int py = p / tile_w;
    const int y = ty * tile_h + py;
    const int x = (tile - ty * grid_x) * tile_w + (p - py * tile_w);
    if (y >= height || x >= width) return;  // the crop (and the grid's tail)
    const float* src = packed + rec * row;
    float* dst = out + (int64_t)y * width + x;
    const int64_t plane = (int64_t)height * width;
    if ((row & 3) == 0 && ((uintptr_t)packed & 15) == 0) {
        for (int c0 = 0; c0 < cols; c0 += 4) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(src + c0));
            dst[c0 * plane] = v.x;
            if (c0 + 1 < cols) dst[(c0 + 1) * plane] = v.y;
            if (c0 + 2 < cols) dst[(c0 + 2) * plane] = v.z;
            if (c0 + 3 < cols) dst[(c0 + 3) * plane] = v.w;
        }
    } else {
        for (int c = 0; c < cols; ++c) dst[c * plane] = __ldg(src + c);
    }
}

}  // namespace

extern "C" {

const char* gs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int gs_untile(const void* packed, int row, int cols, int grid_x,
              int tile_w, int tile_h, int height, int width, void* out,
              void* stream) {
    if (cols <= 0 || height <= 0 || width <= 0) return 0;
    // only the tile rows that meet the image
    const int64_t records = (int64_t)((height + tile_h - 1) / tile_h) * grid_x * tile_w * tile_h;
    const int threads = 256;
    const int64_t blocks = (records + threads - 1) / threads;
    untile_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)packed, row, cols, grid_x, tile_w, tile_h, height, width,
        (float*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
