// K6 segment reduce, variant: a load-balanced block per NV merged items.
// Same result as gaussian_splatting_torch/csrc/segment_reduce.cu (bitwise);
// C interface gs_segment_reduce(rows, offsets, n, P, out, splits, stream),
// with gs_segment_reduce_block_items() for the size of the scratch array
// ``splits``.  tools/torch_layout_ab.py times it against the kernel taken
// (PERF.md).
//
// The merge path of rows and offsets entries (csrc/expand.cu's partition):
// the merged sequence holds every row i (i < n) and every offsets entry b[j]
// (j <= P), an entry going before row i when b[j] <= i.  Each block takes NV
// consecutive merged items, so it holds at most NV rows and at most NV
// entries whatever the offsets.  A first launch finds every block's ends,
// one warp per end, into ``splits``; the main launch is a programmatic
// dependent launch.  A block owns the segments whose entries it holds (those
// that start in its rows), stages their offsets, then the rows they own
// inside the block as one contiguous byte range with 16-byte loads; each
// thread sums one segment front to back from shared memory from +0.0; a
// block's last segment reads its rows past the block on from global memory
// in the same order.  The sums go out through shared memory, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 10;
constexpr int NT = 256;             // threads per block
constexpr int VT = 2;               // merged items per thread
constexpr int NV = NT * VT;         // merged items (rows + offsets entries) per block
// staged floats: NV rows of COLS, from a 16-byte boundary up to 2 floats
// before the first row, in whole float4s
constexpr int STAGE_F4 = (NV * COLS + 2 + 3) / 4;

// The number of offsets entries among the first d merged items: the
// smallest j in [max(0, d - N), min(d, M)] with b[j] > d - 1 - j (the upper
// end if none).  One warp, 32 probes per step; every lane returns the same
// value.  (csrc/expand.cu's merge_path.)
__device__ int merge_path(const int32_t* __restrict__ b, int M, int N, int d, int lane) {
    int lo = max(0, d - N), hi = min(d, M);
    while (lo < hi) {
        const int s = (hi - lo + 31) >> 5;
        const int j = lo + (lane + 1) * s - 1;  // the last of lane's chunk of s
        const bool p = j >= hi || __ldg(b + j) > d - 1 - j;
        const unsigned mask = __ballot_sync(0xffffffffu, p);
        if (mask == 0) return hi;  // lane 31 probed hi - 1, and it was false
        const int f = __ffs(mask) - 1;
        hi = min(lo + (f + 1) * s - 1, hi);
        lo += f * s;
    }
    return lo;
}

// splits[k]: the offsets entries among the first min(k NV, n + P + 1)
// merged items, for k in [0, blocks]; one warp each.
__global__ void segment_reduce_partition_kernel(const int32_t* __restrict__ offsets, int P,
                                                int n, int n_splits,
                                                int32_t* __restrict__ splits) {
    // let the reduce launch start its blocks; they wait for this grid's
    // results at griddepcontrol.wait
    asm volatile("griddepcontrol.launch_dependents;");
    const int k = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (k >= n_splits) return;  // whole warps
    const int d = (int)min((int64_t)k * NV, (int64_t)n + P + 1);
    const int j = merge_path(offsets, P + 1, n, d, threadIdx.x & 31);
    if ((threadIdx.x & 31) == 0) splits[k] = j;
}

__global__ void __launch_bounds__(NT) segment_reduce_kernel(
    const float* __restrict__ rows,       // (n, COLS)
    const int32_t* __restrict__ offsets,  // (P + 1,) non-decreasing, <= n
    const int32_t* __restrict__ splits,   // (blocks + 1,) from the partition launch
    int n, int P,
    float* __restrict__ out)              // (P, COLS)
{
    __shared__ float4 s_rows4[STAGE_F4];  // staged rows; then the block's sums
    __shared__ int32_t s_off[NV + 1];     // offsets of the block's segments and the next
    float* s_rows = reinterpret_cast<float*>(s_rows4);

    const int d1 = min((int)blockIdx.x * NV + NV, n + P + 1);
    asm volatile("griddepcontrol.wait;" ::: "memory");  // the partition launch is done
    const int g0 = splits[blockIdx.x], j1 = splits[blockIdx.x + 1];
    const int g1 = min(j1, P);  // the block's segments: [g0, g1)
    if (g0 >= g1) return;       // none starts here (inside a long segment)
    const int nseg = g1 - g0;
    const int i1 = d1 - j1;     // the end of the block's rows

    for (int w = threadIdx.x; w <= nseg; w += NT) s_off[w] = __ldg(offsets + g0 + w);
    __syncthreads();

    // the rows the block's segments own inside the block, [rs, re), staged
    // from float a0 = rs * COLS rounded down to a 16-byte boundary
    const int rs = s_off[0], re = min(i1, s_off[nseg]);
    const int64_t a0 = ((int64_t)rs * COLS) & ~(int64_t)3;
    const int64_t a1 = (int64_t)re * COLS, end = (int64_t)n * COLS;
    if (((uintptr_t)rows & 15) == 0) {
        const int n4 = re > rs ? (int)((a1 - a0 + 3) >> 2) : 0;
        for (int q = threadIdx.x; q < n4; q += NT) {
            const int64_t f = a0 + 4 * (int64_t)q;
            if (f + 4 <= end) {
                s_rows4[q] = __ldg(reinterpret_cast<const float4*>(rows + f));
            } else {  // the array's last floats: no load past its end
                for (int e = 0; f + e < end; ++e) s_rows[4 * q + e] = __ldg(rows + f + e);
            }
        }
    } else {
        for (int q = threadIdx.x; q < (int)(a1 - a0); q += NT) s_rows[q] = __ldg(rows + a0 + q);
    }
    __syncthreads();

    float acc[VT][COLS];
#pragma unroll
    for (int k = 0; k < VT; ++k) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[k][c] = 0.0f;
        const int w = threadIdx.x + k * NT;
        if (w >= nseg) continue;
        const int lo = s_off[w], hi = s_off[w + 1];
        const int mid = min(hi, re);
        for (int r = lo; r < mid; ++r) {
            // row r starts at an even float: five 8-byte shared loads
            const float2* src = reinterpret_cast<const float2*>(s_rows + ((int64_t)r * COLS - a0));
#pragma unroll
            for (int c = 0; c < COLS / 2; ++c) {
                const float2 v = src[c];
                acc[k][2 * c] = acc[k][2 * c] + v.x;
                acc[k][2 * c + 1] = acc[k][2 * c + 1] + v.y;
            }
        }
#pragma unroll 4
        for (int r = max(lo, re); r < hi; ++r) {  // past the block's rows
            const float* src = rows + (int64_t)r * COLS;
#pragma unroll
            for (int c = 0; c < COLS; ++c) acc[k][c] = acc[k][c] + __ldg(src + c);
        }
    }
    __syncthreads();  // every staged row is read
#pragma unroll
    for (int k = 0; k < VT; ++k) {
        const int w = threadIdx.x + k * NT;
        if (w >= nseg) continue;
#pragma unroll
        for (int c = 0; c < COLS / 2; ++c) {
            reinterpret_cast<float2*>(s_rows)[w * (COLS / 2) + c] =
                make_float2(acc[k][2 * c], acc[k][2 * c + 1]);
        }
    }
    __syncthreads();
    // the block's output rows are contiguous: coalesced 8-byte stores
    float2* dst = reinterpret_cast<float2*>(out + (int64_t)g0 * COLS);
    const float2* s_out = reinterpret_cast<const float2*>(s_rows);
    for (int q = threadIdx.x; q < nseg * (COLS / 2); q += NT) dst[q] = s_out[q];
}

}  // namespace

extern "C" {

const char* gs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// merged items per block: the wrapper's scratch holds (n + P + 1) / NV
// rounded up, plus one, block ends
int gs_segment_reduce_block_items() { return NV; }

int gs_segment_reduce(const void* rows, const void* offsets, int n, int num_gaussians,
                      void* out, void* splits, void* stream) {
    const int P = num_gaussians;
    if (P <= 0) return 0;
    const int n_splits = (int)(((int64_t)n + P + 1 + NV - 1) / NV) + 1;
    const int warps = 8;  // per block of the partition grid
    segment_reduce_partition_kernel<<<(n_splits + warps - 1) / warps, 32 * warps, 0,
                                      (cudaStream_t)stream>>>(
        (const int32_t*)offsets, P, n, n_splits, (int32_t*)splits);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // programmatic dependent launch: the reduce grid is scheduled while the
    // partition runs, so the launch gap between the two is hidden
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_splits - 1);
    cfg.blockDim = dim3(NT);
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(
        &cfg, segment_reduce_kernel, (const float*)rows, (const int32_t*)offsets,
        (const int32_t*)splits, n, P, (float*)out);
}

}  // extern "C"
