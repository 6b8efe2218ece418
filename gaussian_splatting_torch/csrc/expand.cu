// K1 expand: Gaussian table -> one (tile, depth) sort key and one owning
// Gaussian index per instance slot, in expansion order (each Gaussian's
// slots contiguous).
//
// Replaces gaussian_splatting_tpu/ops/expand.py::expand_instances
// (_expand_kernel / _expand_kernel_impl), which expanded a 256-row table
// window per 128-slot chunk with exact one-hot matrix-unit contractions and
// also emitted the nine blend fields per slot.  Here the blend reads its
// fields through the sorted owner index instead, so no field is expanded.
//
// What bounds it on the card: bytes.  Every slot writes 12 bytes (an int64
// key and an int32 owner); the table (~150 bytes per Gaussian) is read once
// in aggregate, and the binary search over the offsets runs out of L1/L2.
// Design: one thread per slot, no cooperation between threads.  The owner is
// the last Gaussian whose exclusive offset is <= the slot (searchsorted
// side="right" minus one, the ownership rule of expand.py).  Neighbouring
// threads own the same or neighbouring Gaussians, so the table reads and the
// key/owner writes coalesce.
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
constexpr float BIG = 16777216.0f;  // 2^24, expand.BIG

__global__ void expand_kernel(
    const int32_t* __restrict__ offsets,    // (P + 1,) exclusive; offsets[P] = total
    const int32_t* __restrict__ rect_x0,    // (P,) tile units
    const int32_t* __restrict__ rect_y0,    // (P,)
    const int32_t* __restrict__ rect_w,     // (P,) >= 1
    const int32_t* __restrict__ span_flag,  // (P,) 0 / 1
    const int32_t* __restrict__ span_x0,    // (P, 16)
    const int32_t* __restrict__ span_cum,   // (P, 16) inclusive cell counts
    const float* __restrict__ depth_key,    // (P,) BIG marks sentinels
    int P, int capacity, int grid_x, int num_tiles,
    int64_t* __restrict__ keys,             // (capacity,) tile << 32 | depth bits
    int32_t* __restrict__ owner)            // (capacity,) in [0, P]
{
    const int slot = blockIdx.x * blockDim.x + threadIdx.x;
    if (slot >= capacity) return;

    // last g in [0, P] with offsets[g] <= slot; offsets[0] == 0 <= slot
    int lo = 0, hi = P;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (offsets[mid] <= slot) lo = mid; else hi = mid - 1;
    }
    const int g = lo;

    int tile = num_tiles;
    float depth = BIG;
    if (g < P) {
        const float d = depth_key[g];
        if (d < BIG) {
            const int local = slot - offsets[g];
            int tx, ty;
            if (span_flag[g]) {
                const int32_t* cum = span_cum + (size_t)g * MAX_SPAN_ROWS;
                const int32_t* x0 = span_x0 + (size_t)g * MAX_SPAN_ROWS;
                int r = 0;
                for (int j = 0; j < MAX_SPAN_ROWS; ++j) r += (cum[j] <= local);
                const int base = r > 0 ? cum[r - 1] : 0;
                const int x0r = r < MAX_SPAN_ROWS ? x0[r] : 0;
                tx = x0r + (local - base);
                ty = rect_y0[g] + r;
            } else {
                const int w = rect_w[g];
                const int q = local / w;
                tx = rect_x0[g] + (local - q * w);
                ty = rect_y0[g] + q;
            }
            tile = ty * grid_x + tx;
            depth = d;
        }
    }
    keys[slot] = ((int64_t)tile << 32) | (int64_t)__float_as_uint(depth);
    owner[slot] = g;
}

}  // namespace

extern "C" {

const char* gs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int gs_expand(const void* offsets, const void* rect_x0, const void* rect_y0,
              const void* rect_w, const void* span_flag, const void* span_x0,
              const void* span_cum, const void* depth_key, int P, int capacity,
              int grid_x, int num_tiles, void* keys, void* owner, void* stream) {
    if (capacity <= 0) return 0;
    const int threads = 256;
    const int blocks = (capacity + threads - 1) / threads;
    expand_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)offsets, (const int32_t*)rect_x0, (const int32_t*)rect_y0,
        (const int32_t*)rect_w, (const int32_t*)span_flag, (const int32_t*)span_x0,
        (const int32_t*)span_cum, (const float*)depth_key, P, capacity, grid_x,
        num_tiles, (int64_t*)keys, (int32_t*)owner);
    return (int)cudaGetLastError();
}

}  // extern "C"
