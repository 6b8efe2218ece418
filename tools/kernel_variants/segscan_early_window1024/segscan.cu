// K7 segmented cumsum, a variant of the package's csrc/segscan.cu that was
// measured and not taken: the window design with every row's copies issued
// at the block's start, before the flags are ranked, over the whole window
// and tail, and each segment's rows walked side by side; blocks of 256
// threads owning windows of 1024 indices.
//
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
// Design: a block owns a window of WINDOW consecutive indices and every
// segment that starts in it (indices before the window's first start belong
// to the block on its left).  It first issues 16-byte cp.async copies of
// ROWS rows over the window and the TAIL indices past it (global to shared
// without registers, all in flight at once), and while they land it reads
// the window's flags, one float4 a thread, and turns them into the sorted
// start positions in shared memory with __ballot_sync and __popc, plus the
// first start in the tail, which ends its last segment; there is no
// division.  Each thread then sums its own segments front to back from +0.0,
// in place in shared memory, all ROWS rows at once (ten independent loads,
// adds and stores a step): the plain twin's order
// (ops/segscan.py::segmented_cumsum_plain), so the two agree to the bit with
// -fmad=false.  The block writes the range from its first start to its last
// segment's end back with float4 stores, scalars at the two ragged ends.  A
// last segment that runs past the staged tail goes on in device memory,
// reading its own flags as it walks.  Measured against the same design at
// other window sizes and against a first form that staged only after the
// flags and walked the rows one after the other
// (tools/kernel_variants/segscan_*; PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // threads per block
constexpr int WINDOW = 1024;  // indices a block owns the segment starts of
constexpr int TAIL = 64;      // indices staged past the window, at most
constexpr int ROWS = 10;      // rows staged at a time
// a row's staged float4s: up to 3 floats before the window (down to a
// 16-byte boundary), the window and the tail
constexpr int STAGE_F4 = (WINDOW + TAIL) / 4 + 1;

static_assert(WINDOW == 4 * THREADS, "one float4 of flags per thread");
static_assert(TAIL % 32 == 0 && TAIL <= THREADS, "whole warps read the tail's flags");
static_assert(WINDOW <= 65536, "start positions fit in 16 bits");

// Stage rows g0 .. g0 + gr - 1 over the window and its tail: shared float
// off(r) + p of row r holds local index p, where off(r) takes the row's
// window start down to a 16-byte boundary when the arrays allow.
__device__ __forceinline__ void stage_rows(
    float4 (*s_rows)[STAGE_F4], const float* __restrict__ vals, int64_t w0, int n,
    int64_t total, int g0, int gr, int stage_lim, bool aligned, int tid)
{
    for (int r = 0; r < gr; ++r) {
        const int64_t lo = (int64_t)(g0 + r) * n + w0;
        const int off = aligned ? (int)(lo & 3) : 0;
        const int64_t a0 = lo - off;
        const int cnt = stage_lim + off;
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
}

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
    const int stage_lim = n - w0 < WINDOW + TAIL ? (int)(n - w0) : WINDOW + TAIL;
    const bool aligned = (((uintptr_t)vals | (uintptr_t)out) & 15) == 0;
    const int64_t total = (int64_t)rows * n;

    // 1. the first rows' copies go out before anything else
    stage_rows(s_rows, vals, w0, n, total, 0, min(ROWS, rows), stage_lim, aligned, tid);

    // 2. the window's flags, one float4 a thread, into ranked start positions
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
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (S == 0) return;  // the window lies inside a segment that starts to its left

    // the block's range, local to the window: [s0, end); the last segment
    // ends at `end` unless it runs past the tail (`past`)
    const int s0 = s_start[0];
    const int end = lim == WINDOW && next < TAIL ? WINDOW + next : stage_lim;
    const bool past = lim == WINDOW && next == TAIL && w0 + WINDOW + TAIL < n;
    float* const s_flat = reinterpret_cast<float*>(s_rows);

    for (int g0 = 0; g0 < rows; g0 += ROWS) {
        const int gr = min(ROWS, rows - g0);
        if (g0 > 0) {
            stage_rows(s_rows, vals, w0, n, total, g0, gr, stage_lim, aligned, tid);
            asm volatile("cp.async.wait_all;\n" ::: "memory");
            __syncthreads();
        }
        int o[ROWS];  // shared float of local index 0, row by row
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
            o[r] = 4 * STAGE_F4 * r + (aligned ? (int)(((int64_t)(g0 + r) * n + w0) & 3) : 0);

        // 3. each thread sums its segments front to back from +0.0, in place,
        // the group's rows side by side: all loads of a step, then the adds,
        // then the stores, so the rows' chains overlap
        for (int k = tid; k < S; k += THREADS) {
            const int p_hi = k + 1 < S ? s_start[k + 1] : end;
            float acc[ROWS];
#pragma unroll
            for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
            for (int p = s_start[k]; p < p_hi; ++p) {
                float v[ROWS];
#pragma unroll
                for (int r = 0; r < ROWS; ++r) v[r] = r < gr ? s_flat[o[r] + p] : 0.0f;
#pragma unroll
                for (int r = 0; r < ROWS; ++r) acc[r] = acc[r] + v[r];
#pragma unroll
                for (int r = 0; r < ROWS; ++r)
                    if (r < gr) s_flat[o[r] + p] = acc[r];
            }
            if (past && k == S - 1) {  // the rest of a segment longer than the tail
                for (int64_t q = w0 + end; q < n && !(__ldg(flags + q) > 0.0f); ++q) {
#pragma unroll
                    for (int r = 0; r < ROWS; ++r) {
                        if (r < gr) {
                            const int64_t i = (int64_t)(g0 + r) * n + q;
                            acc[r] = acc[r] + __ldg(vals + i);
                            out[i] = acc[r];
                        }
                    }
                }
            }
        }
        __syncthreads();

        // 4. write [s0, end) back: float4s inside it, scalars at its ends
        for (int r = 0; r < gr; ++r) {
            const int64_t row_w0 = (int64_t)(g0 + r) * n + w0;
            const int64_t lo = row_w0 + s0, hi = row_w0 + end;
            const int off = o[r] - 4 * STAGE_F4 * r;
            const int64_t a0 = row_w0 - off;  // shared float 0 of the row
            const float* s = reinterpret_cast<const float*>(s_rows[r]);
            if (aligned) {
                for (int q = (int)((lo - a0) >> 2) + tid; q < (int)((hi - a0 + 3) >> 2);
                     q += THREADS) {
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
                for (int q = s0 + tid; q < end; q += THREADS) out[row_w0 + q] = s[q];
            }
        }
        if (g0 + ROWS < rows) __syncthreads();  // the rows are out before the next group lands
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
