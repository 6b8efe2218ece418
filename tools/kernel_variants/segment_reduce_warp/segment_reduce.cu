// K6 segment reduce, variant: one warp per 32 consecutive segments, their
// rows staged per warp.  Same result as gaussian_splatting_torch/csrc/
// segment_reduce.cu (bitwise: each segment summed front to back from +0.0);
// C interface gs_segment_reduce(rows, offsets, n, P, out, stream).
//
// A warp reads its 33 offsets (one coalesced load), then walks the
// contiguous rows of its 32 segments in windows of WINDOW rows: the warp
// stages a window with 16-byte loads (every sector once and whole), each
// lane adds the rows of its own segment that lie in the window, in order,
// to ten running sums in registers, and the warp moves on.  A segment longer
// than a window is summed across windows, still front to back.  The warp's
// 32 result rows (1280 contiguous bytes) go out through its window as
// float4 stores.  No partition launch, no block-wide barrier: warps run
// independently.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 10;
constexpr int WARPS = 4;     // warps per block
constexpr int WINDOW = 128;  // rows staged per warp at a time
// a window's floats from a 16-byte boundary up to 2 floats before its
// first row, in whole float4s
constexpr int WIN_F4 = (WINDOW * COLS + 2 + 3) / 4;

__global__ void __launch_bounds__(32 * WARPS) segment_reduce_kernel(
    const float* __restrict__ rows,       // (n, COLS)
    const int32_t* __restrict__ offsets,  // (P + 1,) non-decreasing, <= n
    int n, int P,
    float* __restrict__ out)              // (P, COLS)
{
    __shared__ float4 s_win4[WARPS][WIN_F4];
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int g0 = (blockIdx.x * WARPS + wid) * 32;
    if (g0 >= P) return;  // whole warps
    float* s = reinterpret_cast<float*>(s_win4[wid]);
    const int lo = __ldg(offsets + min(g0 + lane, P));
    const int whi = __ldg(offsets + min(g0 + 32, P));  // the warp's last row + 1
    int hi = __shfl_down_sync(full, lo, 1);
    if (lane == 31) hi = whi;
    const int wlo = __shfl_sync(full, lo, 0);
    const bool aligned = ((uintptr_t)rows & 15) == 0;
    const int64_t end = (int64_t)n * COLS;

    float acc[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] = 0.0f;
    for (int c0 = wlo; c0 < whi; c0 += WINDOW) {  // warp-uniform
        const int c1 = min(c0 + WINDOW, whi);
        const int64_t a0 = ((int64_t)c0 * COLS) & ~(int64_t)3, a1 = (int64_t)c1 * COLS;
        if (aligned) {
            const int n4 = (int)((a1 - a0 + 3) >> 2);
            for (int q = lane; q < n4; q += 32) {
                const int64_t f = a0 + 4 * (int64_t)q;
                if (f + 4 <= end) {
                    s_win4[wid][q] = __ldg(reinterpret_cast<const float4*>(rows + f));
                } else {  // the array's last floats: no load past its end
                    for (int e = 0; f + e < end; ++e) s[4 * q + e] = __ldg(rows + f + e);
                }
            }
        } else {
            for (int q = lane; q < (int)(a1 - a0); q += 32) s[q] = __ldg(rows + a0 + q);
        }
        __syncwarp();
        const int r1 = min(hi, c1);
        for (int r = max(lo, c0); r < r1; ++r) {
            // row r starts at an even float: five 8-byte shared loads
            const float2* src = reinterpret_cast<const float2*>(s + ((int64_t)r * COLS - a0));
#pragma unroll
            for (int c = 0; c < COLS / 2; ++c) {
                const float2 v = src[c];
                acc[2 * c] = acc[2 * c] + v.x;
                acc[2 * c + 1] = acc[2 * c + 1] + v.y;
            }
        }
        __syncwarp();  // the window is read before the next one lands
    }
    float* dst = out + (int64_t)g0 * COLS;
    if (g0 + 32 <= P && ((uintptr_t)out & 15) == 0) {
        // 32 rows of 40 bytes from a 1280-byte boundary: float4 stores
        float2* s2 = reinterpret_cast<float2*>(s);
#pragma unroll
        for (int c = 0; c < COLS / 2; ++c)
            s2[lane * (COLS / 2) + c] = make_float2(acc[2 * c], acc[2 * c + 1]);
        __syncwarp();
        for (int q = lane; q < 32 * COLS / 4; q += 32)
            reinterpret_cast<float4*>(dst)[q] = s_win4[wid][q];
    } else if (g0 + lane < P) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) dst[lane * COLS + c] = acc[c];
    }
}

}  // namespace

extern "C" {

const char* gs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// rows a warp stages at a time
int gs_segment_reduce_window_rows() { return WINDOW; }

int gs_segment_reduce(const void* rows, const void* offsets, int n, int num_gaussians,
                      void* out, void* stream) {
    const int P = num_gaussians;
    if (P <= 0) return 0;
    const int warps = (P + 31) / 32;
    segment_reduce_kernel<<<(warps + WARPS - 1) / WARPS, 32 * WARPS, 0,
                            (cudaStream_t)stream>>>(
        (const float*)rows, (const int32_t*)offsets, n, P, (float*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
