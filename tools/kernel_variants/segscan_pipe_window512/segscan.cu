// K7 segmented cumsum, a variant of the package's csrc/segscan.cu: the same
// windows of 512 indices (with a tail of 32), walked by persistent blocks
// that rank and stage their next window into a second buffer while they sum
// and store the current one, so each block's copies overlap its own sums
// and stores.  Same contract, order and results as the package's kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // threads per block
constexpr int WINDOW = 512;   // indices a block owns the segment starts of
constexpr int TAIL = 32;      // indices staged past the window, at most
constexpr int ROWS = 10;      // rows staged at a time
constexpr int STAGE_F4 = (WINDOW + TAIL) / 4 + 1;

static_assert(WINDOW == 4 * THREADS, "one float4 of flags per thread");
static_assert(TAIL % 32 == 0 && TAIL <= THREADS, "whole warps read the tail's flags");

struct Window {
    int64_t w0;   // first index
    int S;        // segment starts in the window
    int s0, end;  // the block's range, local: first start .. last segment's end
    bool past;    // the last segment runs past the staged tail
};

// Rank window w0's starts into `starts`; every thread returns the same
// Window.  Two block barriers.
__device__ Window rank_window(int64_t w0, const float* __restrict__ flags, int n,
                              unsigned short* starts, int* s_warp, int* s_tail, int tid) {
    const unsigned full = 0xffffffffu;
    const int lane = tid & 31, wid = tid >> 5;
    const int lim = n - w0 < WINDOW ? (int)(n - w0) : WINDOW;
    const int p0 = 4 * tid;
    bool b[4];
    if (p0 + 4 <= lim && ((uintptr_t)flags & 15) == 0) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(flags + w0 + p0));
        b[0] = f.x > 0.0f; b[1] = f.y > 0.0f; b[2] = f.z > 0.0f; b[3] = f.w > 0.0f;
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) b[k] = p0 + k < lim && __ldg(flags + w0 + p0 + k) > 0.0f;
    }
    if (w0 == 0 && tid == 0) b[0] = true;
    const unsigned below = (1u << lane) - 1u;
    int rank = 0, warp_total = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const unsigned m = __ballot_sync(full, b[k]);
        rank += __popc(m & below);
        warp_total += __popc(m);
    }
    if (lane == 0) s_warp[wid] = warp_total;
    if (tid < TAIL) {
        const int64_t q = w0 + WINDOW + tid;
        const unsigned m = __ballot_sync(full, q < n && __ldg(flags + q) > 0.0f);
        if (lane == 0) s_tail[wid] = m ? 32 * wid + __ffs(m) - 1 : TAIL;
    }
    __syncthreads();
    Window win;
    win.w0 = w0;
    win.S = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
        if (w < wid) rank += s_warp[w];
        win.S += s_warp[w];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
        if (b[k]) starts[rank++] = (unsigned short)(p0 + k);
    int next = TAIL;
#pragma unroll
    for (int w = 0; w < TAIL / 32; ++w) next = min(next, s_tail[w]);
    __syncthreads();
    win.s0 = win.S ? starts[0] : 0;
    win.end = lim;
    win.past = false;
    if (lim == WINDOW) {
        const int tail_lim = n - w0 < WINDOW + TAIL ? (int)(n - w0) : WINDOW + TAIL;
        win.end = next < TAIL ? WINDOW + next : tail_lim;
        win.past = next == TAIL && w0 + WINDOW + TAIL < n;
    }
    return win;
}

// Issue the copies of rows g0 .. g0 + gr - 1 over [s0, end).
__device__ void stage(float4 (*buf)[STAGE_F4], const float* __restrict__ vals, const Window& win,
                      int n, int64_t total, int g0, int gr, bool aligned, int tid) {
    for (int r = 0; r < gr; ++r) {
        const int64_t lo = (int64_t)(g0 + r) * n + win.w0 + win.s0;
        const int off = aligned ? (int)(lo & 3) : 0;
        const int64_t a0 = lo - off;
        const int cnt = win.end - win.s0 + off;
        float* s = reinterpret_cast<float*>(buf[r]);
        if (aligned) {
            for (int q = tid; q < (cnt + 3) >> 2; q += THREADS) {
                const int64_t f = a0 + 4 * q;
                if (f + 4 <= total) {
                    const unsigned sa = (unsigned)__cvta_generic_to_shared(&buf[r][q]);
                    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                                 ::"r"(sa), "l"(vals + f) : "memory");
                } else {
                    for (int e = 0; f + e < total; ++e) s[4 * q + e] = __ldg(vals + f + e);
                }
            }
        } else {
            for (int q = tid; q < cnt; q += THREADS) s[q] = __ldg(vals + a0 + q);
        }
    }
}

__global__ void __launch_bounds__(THREADS) segscan_kernel(
    const float* __restrict__ vals, const float* __restrict__ flags,
    int n, int rows, int num_windows, float* __restrict__ out)
{
    __shared__ float4 s_rows[2][ROWS][STAGE_F4];
    __shared__ unsigned short s_start[2][WINDOW];
    __shared__ int s_warp[THREADS / 32];
    __shared__ int s_tail[TAIL / 32];
    const int tid = threadIdx.x;
    const bool aligned = (((uintptr_t)vals | (uintptr_t)out) & 15) == 0;
    const int64_t total = (int64_t)rows * n;
    if ((int)blockIdx.x >= num_windows) return;

    for (int g0 = 0; g0 < rows; g0 += ROWS) {
        const int gr = min(ROWS, rows - g0);
        int c = 0;
        Window cur = rank_window((int64_t)blockIdx.x * WINDOW, flags, n, s_start[0], s_warp,
                                 s_tail, tid);
        if (cur.S) stage(s_rows[0], vals, cur, n, total, g0, gr, aligned, tid);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
        for (int wi = blockIdx.x; wi < num_windows; wi += gridDim.x) {
            const int wn = wi + gridDim.x;
            Window nxt = cur;
            if (wn < num_windows) {  // the next window's copies go out first
                nxt = rank_window((int64_t)wn * WINDOW, flags, n, s_start[c ^ 1], s_warp,
                                  s_tail, tid);
                if (nxt.S) stage(s_rows[c ^ 1], vals, nxt, n, total, g0, gr, aligned, tid);
            }
            asm volatile("cp.async.commit_group;\n" ::: "memory");
            asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // the current window's
            __syncthreads();
            if (cur.S) {
                const int s0 = cur.s0, end = cur.end;
                const int64_t w0 = cur.w0;
                for (int k = tid; k < cur.S; k += THREADS) {
                    const int p_lo = s_start[c][k], p_hi = k + 1 < cur.S ? s_start[c][k + 1] : end;
                    for (int r = 0; r < gr; ++r) {
                        const int64_t row = (int64_t)(g0 + r) * n;
                        const int off = aligned ? (int)((row + w0 + s0) & 3) : 0;
                        float* s = reinterpret_cast<float*>(s_rows[c][r]) + off;
                        float acc = 0.0f;
                        for (int p = p_lo; p < p_hi; ++p) {
                            acc = acc + s[p - s0];
                            s[p - s0] = acc;
                        }
                        if (cur.past && k == cur.S - 1) {
                            for (int64_t q = w0 + end; q < n && !(__ldg(flags + q) > 0.0f); ++q) {
                                acc = acc + __ldg(vals + row + q);
                                out[row + q] = acc;
                            }
                        }
                    }
                }
                __syncthreads();
                for (int r = 0; r < gr; ++r) {
                    const int64_t lo = (int64_t)(g0 + r) * n + w0 + s0, hi = lo + (end - s0);
                    const int off = aligned ? (int)(lo & 3) : 0;
                    const int64_t a0 = lo - off;
                    const float* s = reinterpret_cast<const float*>(s_rows[c][r]);
                    if (aligned) {
                        for (int q = tid; q < (int)((hi - a0 + 3) >> 2); q += THREADS) {
                            const int64_t f = a0 + 4 * q;
                            if (f >= lo && f + 4 <= hi) {
                                *reinterpret_cast<float4*>(out + f) = s_rows[c][r][q];
                            } else {
#pragma unroll
                                for (int e = 0; e < 4; ++e)
                                    if (f + e >= lo && f + e < hi) out[f + e] = s[4 * q + e];
                            }
                        }
                    } else {
                        for (int q = tid; q < (int)(hi - lo); q += THREADS) out[lo + q] = s[q];
                    }
                }
            }
            __syncthreads();  // buffer c is free for the window after next
            cur = nxt;
            c ^= 1;
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
    }
}

}  // namespace

extern "C" {

const char* gs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int gs_segscan(const void* vals, const void* flags, int n, int rows, void* out,
               void* stream) {
    if (n <= 0 || rows <= 0) return 0;
    static int grid_cap = 0;  // resident blocks on the card
    if (grid_cap == 0) {
        int dev = 0, sms = 0, per_sm = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, segscan_kernel, THREADS, 0);
        grid_cap = sms * per_sm;
    }
    const int num_windows = (int)(((int64_t)n + WINDOW - 1) / WINDOW);
    const int blocks = num_windows < grid_cap ? num_windows : grid_cap;
    segscan_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)vals, (const float*)flags, n, rows, num_windows, (float*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
