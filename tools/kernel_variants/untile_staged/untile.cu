// K3 untile, staged variant (kept for tools/torch_layout_ab.py; the package
// builds gaussian_splatting_torch/csrc/untile.cu).  Same C interface and
// outputs as that kernel.
//
// Design: one block per T_PER tiles of one tile row, as the JAX kernel
// relays one row of tiles per grid step (gaussian_splatting_tpu/ops/
// untile.py::_untile_kernel).  The block reads its records in order (every
// sector once, float4 loads where the record stride allows) into a
// (cols, tile_h, T_PER * tile_w) strip in shared memory, each row padded to
// 16 floats past a multiple of 32 so a warp's two tile rows land on
// distinct banks; then it writes each plane's rows of the strip as whole
// 128-byte lines, with float4 stores where the image width allows.  At most
// CPASS columns are staged at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int T_PER = 8;
constexpr int CPASS = 8;

__host__ __device__ inline int strip_stride(int tile_w) {
    return (T_PER * tile_w + 31) / 32 * 32 + 16;
}

__global__ void __launch_bounds__(NT) untile_kernel(
    const float* __restrict__ packed,  // (num_tiles, tile_h * tile_w, row)
    int row, int cols, int grid_x, int tile_w, int tile_h,
    int height, int width,
    float* __restrict__ out)           // (cols, height, width)
{
    extern __shared__ float4 smem4[];
    float* s = reinterpret_cast<float*>(smem4);
    const int pix = tile_w * tile_h;
    const int tx0 = blockIdx.x * T_PER;
    const int nt = min(T_PER, grid_x - tx0);
    const int x_base = tx0 * tile_w, y_base = blockIdx.y * tile_h;
    const int rows = min(tile_h, height - y_base);
    const int wid = min(nt * tile_w, width - x_base);
    if (wid <= 0) return;
    const int stride = strip_stride(tile_w);
    const int splane = tile_h * stride;
    const int64_t plane = (int64_t)height * width;
    const int64_t rec0 = ((int64_t)blockIdx.y * grid_x + tx0) * pix;
    const bool vin = (row & 3) == 0 && ((uintptr_t)packed & 15) == 0;
    const bool vout = (width & 3) == 0 && (tile_w & 3) == 0 && ((uintptr_t)out & 15) == 0;

    for (int c0 = 0; c0 < cols; c0 += CPASS) {
        const int cn = min(CPASS, cols - c0);
        for (int i = threadIdx.x; i < nt * pix; i += NT) {
            const int t = i / pix, p = i - t * pix;
            const int py = p / tile_w, xs = t * tile_w + (p - py * tile_w);
            if (py >= rows || xs >= wid) continue;  // the crop
            const float* src = packed + (rec0 + i) * row + c0;
            float* dst = s + py * stride + xs;
            if (vin) {
                for (int k = 0; k < cn; k += 4) {
                    const float4 v = __ldg(reinterpret_cast<const float4*>(src + k));
                    dst[k * splane] = v.x;
                    if (k + 1 < cn) dst[(k + 1) * splane] = v.y;
                    if (k + 2 < cn) dst[(k + 2) * splane] = v.z;
                    if (k + 3 < cn) dst[(k + 3) * splane] = v.w;
                }
            } else {
                for (int k = 0; k < cn; ++k) dst[k * splane] = __ldg(src + k);
            }
        }
        __syncthreads();
        if (vout) {
            const int n4 = wid >> 2;
            for (int i = threadIdx.x; i < cn * rows * n4; i += NT) {
                const int k = i / (rows * n4), rem = i - k * rows * n4;
                const int r = rem / n4, q = rem - r * n4;
                const float4 v = *reinterpret_cast<const float4*>(s + k * splane + r * stride + 4 * q);
                *reinterpret_cast<float4*>(out + (c0 + k) * plane + (int64_t)(y_base + r) * width
                                           + x_base + 4 * q) = v;
            }
        } else {
            for (int i = threadIdx.x; i < cn * rows * wid; i += NT) {
                const int k = i / (rows * wid), rem = i - k * rows * wid;
                const int r = rem / wid, q = rem - r * wid;
                out[(c0 + k) * plane + (int64_t)(y_base + r) * width + x_base + q] =
                    s[k * splane + r * stride + q];
            }
        }
        __syncthreads();
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
    const size_t smem = (size_t)(cols < CPASS ? cols : CPASS) * tile_h * strip_stride(tile_w)
                        * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(untile_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((grid_x + T_PER - 1) / T_PER, (height + tile_h - 1) / tile_h);
    untile_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
        (const float*)packed, row, cols, grid_x, tile_w, tile_h, height, width, (float*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
