// PROBE, not a kernel: csrc/expand.cu without its two staged span-row loads
// (its span-mapped slots come out wrong).  tools/torch_layout_ab.py --probe
// times it beside the kernel to show what those loads cost.
//
// K1 expand: Gaussian table -> one (tile, depth) sort key and one owning
// Gaussian index per instance slot, in expansion order (each Gaussian's
// slots contiguous).
//
// Replaces gaussian_splatting_tpu/ops/expand.py::expand_instances
// (_expand_kernel / _expand_kernel_impl), which expanded a 256-row table
// window per 128-slot chunk (its base Gaussian scalar-prefetched by the
// host) with exact one-hot matrix-unit contractions and also emitted the
// nine blend fields per slot.  Here the blend reads its fields through the
// sorted owner index instead, so no field is expanded.
//
// What bounds it on the card: bytes.  Every slot writes 12 bytes (an int64
// key and an int32 owner); each Gaussian's offset and five 4-byte fields are
// read once; and each live span-mapped Gaussian's span_cum and span_x0 rows
// are read at their first 16 bytes, which the memory system fetches as about
// 64 bytes each.  Those two loads take about half of the time
// (tools/kernel_variants/expand_probe_no_rows measures them).  A design that
// came first searched the offsets once per slot (20 dependent loads), then
// scanned the owner's whole span_cum row, touching several sectors per
// warp-load at every step.
//
// Design: a load-balanced search per block (the merge path of slots and
// offsets).  The merged sequence holds every slot i (i < capacity) and every
// offsets entry b[j] (j <= P), an entry going before slot i when b[j] <= i;
// slot i's owner is then the number of entries before it, minus one (the
// last g with offsets[g] <= i: searchsorted side="right" minus one, the
// ownership rule of expand.py).  Each block takes NV consecutive merged
// items, so it holds at most NV slots and at most NV entries whatever the
// offsets (zero-count Gaussians included).  A first launch finds every
// block's ends, one warp per end with a 32-way search over the offsets, into
// a scratch array (the host's chunk bases of the JAX kernel); the main launch
// is a programmatic dependent launch, scheduled while the first runs.  It
// stages the fields of every Gaussian a block's slots can belong to
// in shared memory with coalesced loads, all issued at once: the offset,
// depth key, first rect row, mapping flag, rect x0 and width, then for live
// span-mapped Gaussians the first STAGED_ROWS entries of the span_cum and
// span_x0 rows (one 16-byte load each).  Each slot finds its owner by a
// binary search in the staged offsets and computes its tile and depth from
// shared memory; only a span past STAGED_ROWS rows reads the rest of its
// rows from global memory.  Keys and owners are written in slot order,
// coalesced.
//
// Preconditions (what build_table gives): offsets non-decreasing with
// offsets[0] == 0; span_cum rows non-decreasing (cumulative cell counts);
// rect_w >= 1 on rect-mapped live Gaussians.
//
// Slot -> tile, as in expand.py: span-flagged Gaussians take row
// r = #(span_cum[j] <= local) and tile x span_x0[r] + local - span_cum[r-1];
// the rest walk their full rect row-major.  Sentinel slots (Gaussians with
// no tile), terminator slots (past the total demand) and invalid depths get
// tile = num_tiles and depth = BIG, so they sort to the dropped tail.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SPAN_ROWS = 16;
constexpr int STAGED_ROWS = 4;      // span rows staged per Gaussian (one int4)
constexpr float BIG = 16777216.0f;  // 2^24, expand.BIG
constexpr int NT = 256;             // threads per block
constexpr int VT = 2;               // merged items per thread
constexpr int NV = NT * VT;         // merged items (slots + offsets entries) per block

// The number of offsets entries among the first d merged items: the
// smallest j in [max(0, d - N), min(d, M)] with b[j] > d - 1 - j (the upper
// end if none).  One warp, 32 probes per step, so about log32(M) dependent
// loads; every lane returns the same value.
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

__device__ __forceinline__ int pick(int4 v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// splits[k]: the offsets entries among the first min(k NV, capacity + P + 1)
// merged items, for k in [0, blocks]; one warp each.
__global__ void expand_partition_kernel(const int32_t* __restrict__ offsets, int P, int capacity,
                                 int n_splits, int32_t* __restrict__ splits) {
    // let the expand launch start its blocks; they wait for this grid's
    // results at griddepcontrol.wait
    asm volatile("griddepcontrol.launch_dependents;");
    const int k = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (k >= n_splits) return;  // whole warps
    const int d = (int)min((int64_t)k * NV, (int64_t)capacity + P + 1);
    const int j = merge_path(offsets, P + 1, capacity, d, threadIdx.x & 31);
    if ((threadIdx.x & 31) == 0) splits[k] = j;
}

__global__ void __launch_bounds__(NT, 8) expand_kernel(
    const int32_t* __restrict__ offsets,    // (P + 1,) exclusive; offsets[P] = total
    const int32_t* __restrict__ rect_x0,    // (P,) tile units
    const int32_t* __restrict__ rect_y0,    // (P,)
    const int32_t* __restrict__ rect_w,     // (P,) >= 1
    const int32_t* __restrict__ span_flag,  // (P,) 0 / 1
    const int32_t* __restrict__ span_x0,    // (P, 16), 16-byte aligned
    const int32_t* __restrict__ span_cum,   // (P, 16) inclusive cell counts, 16-byte aligned
    const float* __restrict__ depth_key,    // (P,) BIG marks sentinels
    const int32_t* __restrict__ splits,     // (blocks + 1,) from expand_partition_kernel
    int P, int capacity, int grid_x, int num_tiles,
    int64_t* __restrict__ keys,             // (capacity,) tile << 32 | depth bits
    int32_t* __restrict__ owner)            // (capacity,) in [0, P]
{
    // window Gaussian w is g = j0 - 1 + w, for w in [0, j1 - j0]
    __shared__ int32_t s_off[NV + 1];
    __shared__ float s_depth[NV + 1];  // BIG outside [0, P) and for sentinels
    __shared__ int32_t s_y0[NV + 1];
    __shared__ int32_t s_flag[NV + 1];
    __shared__ int4 s_a[NV + 1];       // span: span_cum[0..3]; rect: (x0, w, -, -)
    __shared__ int4 s_b[NV + 1];       // span: span_x0[0..3]

    const int d0 = blockIdx.x * NV;
    const int d1 = min(d0 + NV, capacity + P + 1);
    asm volatile("griddepcontrol.wait;" ::: "memory");  // the partition launch is done
    const int j0 = splits[blockIdx.x], j1 = splits[blockIdx.x + 1];
    const int i0 = d0 - j0, i1 = d1 - j1;  // the block's slots
    const int nw = j1 - j0 + 1;            // the Gaussians they can belong to

    for (int w = threadIdx.x; w < nw; w += NT) {
        const int g = j0 - 1 + w;
        const bool in = g >= 0 && g < P;
        const int32_t off = g >= 0 ? __ldg(offsets + g) : 0;
        float d = in ? __ldg(depth_key + g) : BIG;
        const int32_t y0 = in ? __ldg(rect_y0 + g) : 0;
        int32_t flag = in ? __ldg(span_flag + g) : 0;
        const int32_t x0 = in ? __ldg(rect_x0 + g) : 0;
        const int32_t rw = in ? __ldg(rect_w + g) : 0;
        int4 a = make_int4(x0, rw, 0, 0), b = make_int4(0, 0, 0, 0);
        if (!(d < BIG)) flag = 0;
        // probe: the two span-row loads are left out, so span slots come out wrong
        s_off[w] = off;
        s_depth[w] = d;
        s_y0[w] = y0;
        s_flag[w] = flag;
        s_a[w] = a;
        s_b[w] = b;
    }
    __syncthreads();

    for (int k = 0; k < VT; ++k) {
        const int slot = i0 + threadIdx.x + k * NT;
        if (slot >= i1) break;
        // the last window entry with offset <= slot (entry 0 is <= slot by
        // the merge path, or is the block-0 placeholder)
        int lo = 0, hi = nw - 1;
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (s_off[mid] <= slot) lo = mid; else hi = mid - 1;
        }
        const int g = j0 - 1 + lo;

        int tile = num_tiles;
        float depth = BIG;
        const float d = s_depth[lo];
        if (d < BIG) {
            const int local = slot - s_off[lo];
            const int4 a = s_a[lo];
            int tx, ty;
            if (s_flag[lo]) {
                int r = (a.x <= local) + (a.y <= local) + (a.z <= local) + (a.w <= local);
                const int32_t* cum = span_cum + (size_t)g * MAX_SPAN_ROWS;
                if (r == STAGED_ROWS) {
                    while (r < MAX_SPAN_ROWS && __ldg(cum + r) <= local) ++r;
                }
                const int base = r == 0 ? 0 : r <= STAGED_ROWS ? pick(a, r - 1) : __ldg(cum + r - 1);
                const int x0r = r < STAGED_ROWS ? pick(s_b[lo], r)
                              : r < MAX_SPAN_ROWS ? __ldg(span_x0 + (size_t)g * MAX_SPAN_ROWS + r)
                              : 0;
                tx = x0r + (local - base);
                ty = s_y0[lo] + r;
            } else {
                const int w = a.y;
                const int q = local / w;
                tx = a.x + (local - q * w);
                ty = s_y0[lo] + q;
            }
            tile = ty * grid_x + tx;
            depth = d;
        }
        keys[slot] = ((int64_t)tile << 32) | (int64_t)__float_as_uint(depth);
        owner[slot] = g;
    }
}

}  // namespace

extern "C" {

const char* gs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// merged items per block: the wrapper's scratch holds (capacity + P + 1) / NV
// rounded up, plus one, block ends
int gs_expand_block_items() { return NV; }

int gs_expand(const void* offsets, const void* rect_x0, const void* rect_y0,
              const void* rect_w, const void* span_flag, const void* span_x0,
              const void* span_cum, const void* depth_key, int P, int capacity,
              int grid_x, int num_tiles, void* keys, void* owner, void* splits,
              void* stream) {
    if (capacity <= 0) return 0;
    const int n_splits = (int)(((int64_t)capacity + P + 1 + NV - 1) / NV) + 1;
    const int warps = 8;  // per block of the partition grid
    expand_partition_kernel<<<(n_splits + warps - 1) / warps, 32 * warps, 0,
                              (cudaStream_t)stream>>>(
        (const int32_t*)offsets, P, capacity, n_splits, (int32_t*)splits);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // programmatic dependent launch: the expand grid is scheduled while the
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
        &cfg, expand_kernel,
        (const int32_t*)offsets, (const int32_t*)rect_x0, (const int32_t*)rect_y0,
        (const int32_t*)rect_w, (const int32_t*)span_flag, (const int32_t*)span_x0,
        (const int32_t*)span_cum, (const float*)depth_key, (const int32_t*)splits, P,
        capacity, grid_x, num_tiles, (int64_t*)keys, (int32_t*)owner);
}

}  // extern "C"
