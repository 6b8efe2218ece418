// K7 segmented cumsum: inclusive running sums along each row of a (rows, n)
// float32 array, restarting at every index i with flags[i] > 0 (and at 0).
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
// once, one add per value; n flags read).  A first design ran one thread per
// (row, index): rows * n threads, each with a 64-bit modulo, nearly all of
// which exited at once, while each start thread walked its segment in
// device memory and read every flag again for each row
// (tools/kernel_variants/segscan_thread).
//
// Design: a block of THREADS threads owns a window of WINDOW consecutive
// indices and every segment that starts in it (indices before the window's
// first start belong to the block on its left).  It reads the window's
// flags once, one float4 a thread, and turns them into the sorted start
// positions in shared memory with __ballot_sync and __popc, plus the first
// start in the TAIL indices past the window, which ends its last segment;
// there is no division.  Then, ROWS rows at a time, it stages each row's
// values from its first start to that end with 16-byte cp.async copies
// (global to shared without registers, all in flight before one wait), each
// thread sums its own segments front to back from +0.0 in place in shared
// memory (the plain twin's order: ops/segscan.py::segmented_cumsum_plain, so
// the two agree to the bit with -fmad=false), and the block writes the
// results back with float4 stores, scalars at the range's two ragged ends.
// A last segment that runs past the staged tail goes on in device memory,
// reading its own flags as it walks.  Measured on the card against the same
// design at windows of 1024, 256 and 128 (one warp), against issuing every
// copy before the flags are ranked, against walking a segment's rows side by
// side, and against persistent blocks that stage their next window while
// they finish the current one: all slower (tools/kernel_variants/segscan_*;
// PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // threads per block
constexpr int WINDOW = 512;   // indices a block owns the segment starts of
constexpr int TAIL = 64;      // indices staged past the window, at most
constexpr int ROWS = 10;      // rows staged at a time
// a row's staged float4s: up to 3 floats before its first start (down to a
// 16-byte boundary) and the window and tail after it
constexpr int STAGE_F4 = (WINDOW + TAIL) / 4 + 1;

static_assert(WINDOW == 4 * THREADS, "one float4 of flags per thread");
static_assert(TAIL % 32 == 0 && TAIL <= THREADS, "whole warps read the tail's flags");
static_assert(WINDOW <= 65536, "start positions fit in 16 bits");

__global__ void __launch_bounds__(THREADS) segscan_kernel(
    const float* __restrict__ vals,   // (rows, n)
    const float* __restrict__ flags,  // (n,)
    int n, int rows,
    float* __restrict__ out)          // (rows, n)
{
    __shared__ float4 s_rows[ROWS][STAGE_F4];
    __shared__ unsigned short s_start[WINDOW];
    __shared__ int s_warp[THREADS / 32];
    __shared__ int s_tail[TAIL / 32];
    const unsigned full = 0xffffffffu;
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    const int64_t w0 = (int64_t)blockIdx.x * WINDOW;
    const int lim = n - w0 < WINDOW ? (int)(n - w0) : WINDOW;  // the window's indices

    // 1. the window's flags, one float4 a thread, into ranked start positions
    const int p0 = 4 * tid;
    bool b[4];
    if (p0 + 4 <= lim && ((uintptr_t)flags & 15) == 0) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(flags + w0 + p0));
        b[0] = f.x > 0.0f; b[1] = f.y > 0.0f; b[2] = f.z > 0.0f; b[3] = f.w > 0.0f;
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) b[k] = p0 + k < lim && __ldg(flags + w0 + p0 + k) > 0.0f;
    }
    if (w0 == 0 && tid == 0) b[0] = true;  // index 0 starts a segment
    const unsigned below = (1u << lane) - 1u;
    int rank = 0, warp_total = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const unsigned m = __ballot_sync(full, b[k]);
        rank += __popc(m & below);
        warp_total += __popc(m);
    }
    if (lane == 0) s_warp[wid] = warp_total;
    if (tid < TAIL) {  // whole warps: the first start past the window
        const int64_t q = w0 + WINDOW + tid;
        const unsigned m = __ballot_sync(full, q < n && __ldg(flags + q) > 0.0f);
        if (lane == 0) s_tail[wid] = m ? 32 * wid + __ffs(m) - 1 : TAIL;
    }
    __syncthreads();
    int S = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
        if (w < wid) rank += s_warp[w];
        S += s_warp[w];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
        if (b[k]) s_start[rank++] = (unsigned short)(p0 + k);
    int next = TAIL;
#pragma unroll
    for (int w = 0; w < TAIL / 32; ++w) next = min(next, s_tail[w]);
    __syncthreads();
    if (S == 0) return;  // the window lies inside a segment that starts to its left

    // the staged range, local to the window: [s0, end); the last segment
    // ends at `end` unless it runs past the tail (`past`)
    const int s0 = s_start[0];
    int end = lim;
    bool past = false;
    if (lim == WINDOW) {
        const int tail_lim = n - w0 < WINDOW + TAIL ? (int)(n - w0) : WINDOW + TAIL;
        end = next < TAIL ? WINDOW + next : tail_lim;
        past = next == TAIL && w0 + WINDOW + TAIL < n;
    }
    const bool aligned = (((uintptr_t)vals | (uintptr_t)out) & 15) == 0;
    const int64_t total = (int64_t)rows * n;

    for (int g0 = 0; g0 < rows; g0 += ROWS) {
        const int gr = min(ROWS, rows - g0);
        // 2. stage the group's rows: shared float q of row r holds the
        // value at a0 + q, from a 16-byte boundary when the arrays allow
        for (int r = 0; r < gr; ++r) {
            const int64_t lo = (int64_t)(g0 + r) * n + w0 + s0;
            const int off = aligned ? (int)(lo & 3) : 0;
            const int64_t a0 = lo - off;
            const int cnt = end - s0 + off;
            float* s = reinterpret_cast<float*>(s_rows[r]);
            if (aligned) {
                for (int q = tid; q < (cnt + 3) >> 2; q += THREADS) {
                    const int64_t f = a0 + 4 * q;
                    if (f + 4 <= total) {
                        const unsigned sa = (unsigned)__cvta_generic_to_shared(&s_rows[r][q]);
                        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                                     ::"r"(sa), "l"(vals + f) : "memory");
                    } else {  // the array's last floats: no load past its end
                        for (int e = 0; f + e < total; ++e) s[4 * q + e] = __ldg(vals + f + e);
                    }
                }
            } else {
                for (int q = tid; q < cnt; q += THREADS) s[q] = __ldg(vals + a0 + q);
            }
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();

        // 3. each thread sums its segments front to back from +0.0, in place
        for (int k = tid; k < S; k += THREADS) {
            const int p_lo = s_start[k], p_hi = k + 1 < S ? s_start[k + 1] : end;
            for (int r = 0; r < gr; ++r) {
                const int64_t row = (int64_t)(g0 + r) * n;
                const int off = aligned ? (int)((row + w0 + s0) & 3) : 0;
                float* s = reinterpret_cast<float*>(s_rows[r]) + off;
                float acc = 0.0f;
                for (int p = p_lo; p < p_hi; ++p) {
                    acc = acc + s[p - s0];
                    s[p - s0] = acc;
                }
                if (past && k == S - 1) {  // the rest of a segment longer than the tail
                    for (int64_t q = w0 + end; q < n && !(__ldg(flags + q) > 0.0f); ++q) {
                        acc = acc + __ldg(vals + row + q);
                        out[row + q] = acc;
                    }
                }
            }
        }
        __syncthreads();

        // 4. write the staged range back: float4s inside it, scalars at its ends
        for (int r = 0; r < gr; ++r) {
            const int64_t lo = (int64_t)(g0 + r) * n + w0 + s0, hi = lo + (end - s0);
            const int off = aligned ? (int)(lo & 3) : 0;
            const int64_t a0 = lo - off;
            const float* s = reinterpret_cast<const float*>(s_rows[r]);
            if (aligned) {
                for (int q = tid; q < (int)((hi - a0 + 3) >> 2); q += THREADS) {
                    const int64_t f = a0 + 4 * q;
                    if (f >= lo && f + 4 <= hi) {
                        *reinterpret_cast<float4*>(out + f) = s_rows[r][q];
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
        __syncthreads();  // the rows are written before the next group lands
    }
}

}  // namespace

extern "C" {

const char* gs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// indices whose segment starts a block owns
int gs_segscan_window() { return WINDOW; }

int gs_segscan(const void* vals, const void* flags, int n, int rows, void* out,
               void* stream) {
    if (n <= 0 || rows <= 0) return 0;
    const int blocks = (int)(((int64_t)n + WINDOW - 1) / WINDOW);
    segscan_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)vals, (const float*)flags, n, rows, (float*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
