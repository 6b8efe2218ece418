// K7 segmented cumsum, the first design, which the package's csrc/segscan.cu
// ran before its window design: inclusive running sums along each row of a
// (rows, n) float32 array, restarting at every index i with flags[i] > 0 (and
// at 0).
//
// Replaces gaussian_splatting_tpu/ops/segscan.py::segmented_cumsum
// (_segscan_kernel), which ran a lane-axis Hillis-Steele scan over 2048-wide
// blocks in grid order and carried the running value between blocks in
// VMEM scratch.  Same contract: out[:, i] is the sum of vals[:, j..i] since
// the last start j <= i, every segment starts from a carry of +0.0 (so a
// segment of exact zeros scans to exact +0.0 zeros, as JAX's scan, which
// adds its carry or 0.0 to every lane, gives), and no difference of
// prefixes is ever taken, so no rounding dust leaks into zero segments.
//
// What bounds it on the card: bytes (each value read once, each sum written
// once, one add per value; n flags read).  Design, simple first: one thread
// per (row, index); a thread whose index starts a segment walks front to
// back to the next start, writing the running sum, and every other thread
// exits at once.  Neighbouring threads read neighbouring flags.  The plain
// twin (ops/segscan.py::segmented_cumsum_plain) adds in the same order, and
// with -fmad=false the two agree to the bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void segscan_kernel(
    const float* __restrict__ vals,   // (rows, n)
    const float* __restrict__ flags,  // (n,)
    int64_t n,
    int64_t total,                    // rows * n
    float* __restrict__ out)          // (rows, n)
{
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= total) return;
    const int64_t i = t % n;
    if (i != 0 && !(flags[i] > 0.0f)) return;
    const int64_t row = t - i;  // r * n
    float acc = 0.0f;
    int64_t j = i;
    do {
        acc = acc + vals[row + j];
        out[row + j] = acc;
        ++j;
    } while (j < n && !(flags[j] > 0.0f));
}

}  // namespace

extern "C" {

const char* gs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int gs_segscan(const void* vals, const void* flags, int n, int rows, void* out,
               void* stream) {
    const int64_t total = (int64_t)n * rows;
    if (total <= 0) return 0;
    const int threads = 256;
    const int64_t blocks = (total + threads - 1) / threads;
    segscan_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)vals, (const float*)flags, (int64_t)n, total, (float*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
