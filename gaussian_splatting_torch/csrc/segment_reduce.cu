// K6 segment reduce: per-Gaussian sums of gradient rows in expansion order.
// Gaussian g owns the contiguous rows [offsets[g], offsets[g + 1]) of a
// (n, 10) array (the wrapper clamps the offsets to n); the result is (P, 10).
//
// Replaces gaussian_splatting_tpu/ops/segreduce.py::segment_reduce_rows
// (_segreduce_kernel), which reduced 128-row chunks into a rolling window of
// per-Gaussian sums with one-hot matrix-unit products.  Same contract:
// expansion order is monotone in Gaussian index, and a Gaussian none of
// whose rows carries gradient gets exact zeros (Adam would turn gradient
// dust into full-size steps).
//
// What bounds it on the card: bytes (each row read once, each sum written
// once; one add per value).  Design: one thread per Gaussian sums its own
// segment front to back, ten running sums in registers, then writes its
// row.  No atomics, so the result is deterministic, and the plain twin
// (ops/segreduce.py::segment_reduce_rows_plain) adds in the same order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 10;

__global__ void segment_reduce_kernel(
    const float* __restrict__ rows,       // (n, COLS)
    const int32_t* __restrict__ offsets,  // (num_gaussians + 1,) clamped to n
    int num_gaussians,
    float* __restrict__ out)              // (num_gaussians, COLS)
{
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= num_gaussians) return;
    const int lo = offsets[g];
    const int hi = offsets[g + 1];
    float acc[COLS];
#pragma unroll
    for (int k = 0; k < COLS; ++k) acc[k] = 0.0f;
    for (int i = lo; i < hi; ++i) {
        const float* r = rows + (size_t)i * COLS;
#pragma unroll
        for (int k = 0; k < COLS; ++k) acc[k] = acc[k] + r[k];
    }
    float* o = out + (size_t)g * COLS;
#pragma unroll
    for (int k = 0; k < COLS; ++k) o[k] = acc[k];
}

}  // namespace

extern "C" {

const char* gs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int gs_segment_reduce(const void* rows, const void* offsets, int num_gaussians,
                      void* out, void* stream) {
    if (num_gaussians <= 0) return 0;
    const int threads = 256;
    const int blocks = (num_gaussians + threads - 1) / threads;
    segment_reduce_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)rows, (const int32_t*)offsets, num_gaussians, (float*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
