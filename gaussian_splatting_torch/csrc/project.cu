// K8 project: the per-Gaussian stage of an inference render in one pass,
// from a model's stored tensors to the (P, 10) blend table, the radii and
// K1's expansion table.
//
// Replaces no Pallas kernel: the JAX package leaves this stage to XLA
// (train/loop.py::_activated_params, ops/preprocess.py, ops/sh.py), which
// fuses it.  Its twin in the port is the plain PyTorch chain
// GaussianModel.activated_params -> ops/preprocess.py::preprocess ->
// ops/rasterize.py::blend_fields -> ops/instances.py::build_table, some 1650
// small launches a view that keep every intermediate in device memory
// (a (P, 16, 3) SH copy among them).
//
// Per Gaussian, in the twin's operation order: the activations (exp, the
// quaternion's norm, sigmoid times alive, SH coefficients above the active
// degree read as 0); view and clip projection, the 3D and the EWA 2D
// covariance; dilation and the antialiasing rescale, the conic, the radius
// and the cut radius; the tile rect, the 16 ellipse span rows and the tile
// count; the SH colour.  Written once: the blend table, the radii, every
// column of the expansion table but its offsets, and 0 followed by the slot
// counts, which one cumsum in place turns into the offsets.
//
// What bounds it on this card: bytes.  At SH degree 3 a Gaussian reads
// 237 B of stored rows and writes 196 B, about 2 operations a byte, far
// below the ridge.  Design: one thread per Gaussian, blocks of 128.  The
// array-of-structs rows (means, log-scales, SH DC: 12 B each; SH rest: 180 B
// at degree 3, 288 B at degree 4) are staged through shared memory with
// 16-byte loads, so each warp reads contiguous memory; the blend table's
// 40-byte rows and the two 64-byte span rows go out the same way, through
// the space the SH rows took once the colours are made.  Rows in shared
// memory have an odd stride, so the threads of a warp reading their own
// rows hit 32 different banks.  The SH degree is a template parameter.
//
// Bits: every output equals its twin's, bit for bit.  The build contracts
// no multiply-add (-fmad=false) and keeps IEEE division and square root.
// Each operation is written as PyTorch's CUDA kernels compute it: x / s for
// a Python scalar s is x * (1 / s); 1 / x is a reciprocal; torch.maximum /
// torch.minimum and torch.clamp propagate NaN; the two row sums are reduced
// as PyTorch's reduction kernel reduces a row of 3 or 4 (two lanes, then a
// shuffle); eval_sh adds its terms left to right.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int SPAN_ROWS = 16;
constexpr int SPAN_LIMIT = 4096;
constexpr int NUM_FIELDS = 10;
constexpr float BIG = 16777216.0f;  // ops/expand.py BIG: a sentinel's depth key
// odd row strides of the staged output rows
constexpr int FIELDS_STRIDE = NUM_FIELDS + 1;
constexpr int SPAN_STRIDE = SPAN_ROWS + 1;
constexpr int OUT_FLOATS = FIELDS_STRIDE + 2 * SPAN_STRIDE;  // per thread
constexpr int CAM_FLOATS = 36;  // view matrix, full projection, camera centre

// ---- per-Gaussian arithmetic

// A Python float constant as PyTorch hands it to a float32 kernel.
#define F(x) ((float)(x))

// torch.maximum / torch.minimum of floats: a NaN operand propagates.
__device__ __forceinline__ float t_max(float a, float b) {
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float t_min(float a, float b) {
    return a != a ? a : (b != b ? b : fminf(a, b));
}
// torch.clamp(x, min=lo) and torch.clamp(x, lo, hi) with scalar bounds.
__device__ __forceinline__ float t_clamp_min(float v, float lo) {
    return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float t_clamp(float v, float lo, float hi) {
    return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ int clamp_int(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}
// ops/preprocess.py::_to_int32: truncation after a clamp into int32's range.
__device__ __forceinline__ int to_int32(float x) {
    return (int)t_clamp(x, -2147483648.0f, 2147483392.0f);
}
// (v * v).sum(-1) over rows of 3 and 4, as PyTorch's CUDA reduction adds
// them: lanes take elements (0, 2) and (1) or (0, 2) and (1, 3), then one
// shuffle adds the lanes.
__device__ __forceinline__ float row_sum3(float a, float b, float c) {
    return (a + c) + b;
}
__device__ __forceinline__ float row_sum4(float a, float b, float c, float d) {
    return (a + c) + (b + d);
}

// ops/sh.py's constants
#define SH_C0 F(0.28209479177387814)
#define SH_C1 F(0.4886025119029199)

// sh_to_color at degree D over the coefficients that the active degree
// keeps: ``mean`` and ``campos`` 3 floats, ``dc`` the DC row, ``rest`` the
// row of features_rest (coefficient k, channel c at (k - 1) * 3 + c).
template <int D>
__device__ void sh_color(const float* mean, const float* campos, const float* dc,
                                  const float* rest, int active, float* rgb) {
    constexpr int K = (D + 1) * (D + 1);
    const float d0 = mean[0] - campos[0];
    const float d1 = mean[1] - campos[1];
    const float d2 = mean[2] - campos[2];
    const float norm = sqrtf(row_sum3(d0 * d0, d1 * d1, d2 * d2));
    const float x = d0 / norm, y = d1 / norm, z = d2 / norm;
    float basis[K];
    if constexpr (D > 0) {
        basis[1] = SH_C1 * y;  // subtracted
        basis[2] = SH_C1 * z;
        basis[3] = SH_C1 * x;  // subtracted
    }
    if constexpr (D > 1) {
        const float xx = x * x, yy = y * y, zz = z * z;
        const float xy = x * y, yz = y * z, xz = x * z;
        basis[4] = F(1.0925484305920792) * xy;
        basis[5] = F(-1.0925484305920792) * yz;
        basis[6] = F(0.31539156525252005) * ((F(2.0) * zz - xx) - yy);
        basis[7] = F(-1.0925484305920792) * xz;
        basis[8] = F(0.5462742152960396) * (xx - yy);
        if constexpr (D > 2) {
            basis[9] = (F(-0.5900435899266435) * y) * (F(3.0) * xx - yy);
            basis[10] = (F(2.890611442640554) * xy) * z;
            basis[11] = (F(-0.4570457994644658) * y) * ((F(4.0) * zz - xx) - yy);
            basis[12] = (F(0.3731763325901154) * z) * ((F(2.0) * zz - F(3.0) * xx) - F(3.0) * yy);
            basis[13] = (F(-0.4570457994644658) * x) * ((F(4.0) * zz - xx) - yy);
            basis[14] = (F(1.445305721320277) * z) * (xx - yy);
            basis[15] = (F(-0.5900435899266435) * x) * (xx - F(3.0) * yy);
        }
        if constexpr (D > 3) {
            basis[16] = (F(2.5033429417967046) * xy) * (xx - yy);
            basis[17] = (F(-1.7701307697799304) * yz) * (F(3.0) * xx - yy);
            basis[18] = (F(0.9461746957575601) * xy) * (F(7.0) * zz - F(1.0));
            basis[19] = (F(-0.6690465435572892) * yz) * (F(7.0) * zz - F(3.0));
            basis[20] = F(0.10578554691520431) * (zz * (F(35.0) * zz - F(30.0)) + F(3.0));
            basis[21] = (F(-0.6690465435572892) * xz) * (F(7.0) * zz - F(3.0));
            basis[22] = (F(0.47308734787878004) * (xx - yy)) * (F(7.0) * zz - F(1.0));
            basis[23] = (F(-1.7701307697799304) * xz) * (xx - F(3.0) * yy);
            basis[24] = F(0.6258357354491761) * (xx * (xx - F(3.0) * yy) - yy * (F(3.0) * xx - yy));
        }
    }
    // activated_params zeroes the coefficients above the active degree
    const int kept = (active + 1) * (active + 1);
    for (int c = 0; c < 3; ++c) {
        float r = SH_C0 * dc[c];
#pragma unroll
        for (int k = 1; k < K; ++k) {
            const float coef = k < kept ? rest[(k - 1) * 3 + c] : 0.0f;
            const float term = basis[k] * coef;
            r = (k == 1 || k == 3) ? r - term : r + term;
        }
        r = r + F(0.5);
        rgb[c] = t_max(r, 0.0f);
    }
}

// What project_geometry needs besides the Gaussian's rows.
struct Scalars {
    float scale_modifier, limx, limy, fx, fy;
    int width, height, grid_x, grid_y, tile_w, tile_h, antialiasing;
};

// Per-Gaussian outputs other than the staged rows.
struct Row {
    int radius, rect_x0, rect_y0, rect_w, span_flag, count;
    float depth_key;
};

// activated_params (bar SH) -> preprocess -> blend_fields -> build_table's
// columns for one Gaussian.  ``V``, ``PM``: the view and full projection
// matrices, row-major.  Writes ``fields`` (10), ``x0`` and ``cum`` (16 each)
// and ``row``.
__device__ void project_geometry(const float* mean, const float* log_scale,
                                          const float* q, float opacity_logit, bool alive,
                                          const float* rgb, const float* V, const float* PM,
                                          const Scalars& s, float* fields, int* x0, int* cum,
                                          Row& row) {
    const float m0 = mean[0], m1 = mean[1], m2 = mean[2];
    // activated_params
    const float sc0 = expf(log_scale[0]), sc1 = expf(log_scale[1]), sc2 = expf(log_scale[2]);
    const float qnorm = sqrtf(row_sum4(q[0] * q[0], q[1] * q[1], q[2] * q[2], q[3] * q[3]));
    const float qw = q[0] / qnorm, qx = q[1] / qnorm, qy = q[2] / qnorm, qz = q[3] / qnorm;
    const float opacity = (1.0f / (1.0f + expf(-opacity_logit))) * (alive ? 1.0f : 0.0f);

    // frustum cull, projection and perspective divide
    const float t0 = ((m0 * V[0] + m1 * V[1]) + m2 * V[2]) + V[3];
    const float t1 = ((m0 * V[4] + m1 * V[5]) + m2 * V[6]) + V[7];
    const float depth = ((m0 * V[8] + m1 * V[9]) + m2 * V[10]) + V[11];
    const bool in_front = depth > F(0.2);
    const float ph0 = ((m0 * PM[0] + m1 * PM[1]) + m2 * PM[2]) + PM[3];
    const float ph1 = ((m0 * PM[4] + m1 * PM[5]) + m2 * PM[6]) + PM[7];
    float w_hom = ((m0 * PM[12] + m1 * PM[13]) + m2 * PM[14]) + PM[15];
    w_hom = in_front ? w_hom : 1.0f;
    const float p_w = 1.0f / (w_hom + F(1e-7));
    const float mx = (((ph0 * p_w) + 1.0f) * (float)s.width - 1.0f) * 0.5f;
    const float my = (((ph1 * p_w) + 1.0f) * (float)s.height - 1.0f) * 0.5f;

    // transforms.py::build_covariance
    const float s0 = s.scale_modifier * sc0, s1 = s.scale_modifier * sc1,
                s2 = s.scale_modifier * sc2;
    const float r00 = 1.0f - 2.0f * (qy * qy + qz * qz);
    const float r01 = 2.0f * (qx * qy - qw * qz);
    const float r02 = 2.0f * (qx * qz + qw * qy);
    const float r10 = 2.0f * (qx * qy + qw * qz);
    const float r11 = 1.0f - 2.0f * (qx * qx + qz * qz);
    const float r12 = 2.0f * (qy * qz - qw * qx);
    const float r20 = 2.0f * (qx * qz - qw * qy);
    const float r21 = 2.0f * (qy * qz + qw * qx);
    const float r22 = 1.0f - 2.0f * (qx * qx + qy * qy);
    const float L00 = r00 * s0, L01 = r01 * s1, L02 = r02 * s2;
    const float L10 = r10 * s0, L11 = r11 * s1, L12 = r12 * s2;
    const float L20 = r20 * s0, L21 = r21 * s1, L22 = r22 * s2;
    const float cxx3 = (L00 * L00 + L01 * L01) + L02 * L02;
    const float cxy3 = (L00 * L10 + L01 * L11) + L02 * L12;
    const float cxz3 = (L00 * L20 + L01 * L21) + L02 * L22;
    const float cyy3 = (L10 * L10 + L11 * L11) + L12 * L12;
    const float cyz3 = (L10 * L20 + L11 * L21) + L12 * L22;
    const float czz3 = (L20 * L20 + L21 * L21) + L22 * L22;

    // preprocess.py::compute_cov2d
    const float tz = t_max(depth, F(0.2));
    const float tx = t_min(t_max(t0 / tz, -s.limx), s.limx) * tz;
    const float ty = t_min(t_max(t1 / tz, -s.limy), s.limy) * tz;
    const float inv_z = 1.0f / tz;
    const float inv_z2 = inv_z * inv_z;
    const float j00 = s.fx * inv_z;
    const float j02 = (-s.fx * tx) * inv_z2;
    const float j11 = s.fy * inv_z;
    const float j12 = (-s.fy * ty) * inv_z2;
    float M0[3], M1[3];
    for (int k = 0; k < 3; ++k) {
        M0[k] = j00 * V[k] + j02 * V[8 + k];
        M1[k] = j11 * V[4 + k] + j12 * V[8 + k];
    }
    const float sa0 = (M0[0] * cxx3 + M0[1] * cxy3) + M0[2] * cxz3;
    const float sa1 = (M0[0] * cxy3 + M0[1] * cyy3) + M0[2] * cyz3;
    const float sa2 = (M0[0] * cxz3 + M0[1] * cyz3) + M0[2] * czz3;
    const float sb0 = (M1[0] * cxx3 + M1[1] * cxy3) + M1[2] * cxz3;
    const float sb1 = (M1[0] * cxy3 + M1[1] * cyy3) + M1[2] * cyz3;
    const float sb2 = (M1[0] * cxz3 + M1[1] * cyz3) + M1[2] * czz3;
    const float c0 = (sa0 * M0[0] + sa1 * M0[1]) + sa2 * M0[2];
    const float c1 = (sa0 * M1[0] + sa1 * M1[1]) + sa2 * M1[2];
    const float c2 = (sb0 * M1[0] + sb1 * M1[1]) + sb2 * M1[2];

    // dilation and the antialiasing rescale, conic, radius
    const float det_orig = c0 * c2 - c1 * c1;
    const float cxx = c0 + F(0.3), cyy = c2 + F(0.3), cxy = c1;
    const float det = cxx * cyy - cxy * cxy;
    const float aa_scale = s.antialiasing ? sqrtf(t_max(det_orig / det, F(0.000025))) : 1.0f;
    const bool det_ok = det != 0.0f;
    const float det_inv = 1.0f / (det_ok ? det : 1.0f);
    const float ca = cyy * det_inv, cb = -cxy * det_inv, cc = cxx * det_inv;
    const float mid = 0.5f * (cxx + cyy);
    const float lam1 = mid + sqrtf(t_max(mid * mid - det, F(0.1)));
    const float radius_f = ceilf(3.0f * sqrtf(lam1));

    // opacity-aware cut radius, per-axis ellipse extents, tile rect
    const float op_cut = opacity * aa_scale;
    const float log_term = 2.0f * logf(t_max(255.0f * op_cut, 1.0f));
    const float r_cut = t_min(sqrtf(lam1 * log_term), radius_f);
    const float taus = log_term + F(1e-3);
    const float ell_x = sqrtf(t_clamp_min(taus * cxx, 0.0f)) + F(0.1);
    const float ell_y = sqrtf(t_clamp_min(taus * cyy, 0.0f)) + F(0.1);
    const bool is_pd = det > 0.0f;
    const float rect_rx = ceilf(is_pd ? t_min(ell_x, r_cut) : r_cut);
    const float rect_ry = ceilf(is_pd ? t_min(ell_y, r_cut) : r_cut);
    const float inv_tw = 1.0f / (float)s.tile_w, inv_th = 1.0f / (float)s.tile_h;
    const int rx_min = clamp_int(to_int32((mx - rect_rx) * inv_tw), 0, s.grid_x);
    const int ry_min = clamp_int(to_int32((my - rect_ry) * inv_th), 0, s.grid_y);
    const int rx_max = clamp_int(to_int32(floorf((mx + rect_rx) * inv_tw)) + 1, 0, s.grid_x);
    const int ry_max = clamp_int(to_int32(floorf((my + rect_ry) * inv_th)) + 1, 0, s.grid_y);

    // preprocess.py::compute_tile_spans: rows at or past rect_h hold no
    // span, and a Gaussian off the span mapping keeps zero rows
    const int rect_w = rx_max - rx_min, rect_h = ry_max - ry_min;
    const float detc = ca * cc - cb * cb;
    bool is_span = rect_h <= SPAN_ROWS && rect_h > 0 && rect_w > 0 && detc > 0.0f &&
                   ca > 0.0f && cc > 0.0f;
    int total = 0;
    if (is_span) {
        const float inv_a = 1.0f / t_clamp_min(ca, F(1e-30));
        const float dy_lim = sqrtf(t_clamp_min(taus * ca, 0.0f) / t_clamp_min(detc, F(1e-30)));
        const float s_shared = sqrtf(t_clamp_min(taus, 0.0f) / t_clamp_min(cc * detc, F(1e-30)));
        const float dy_star = -cb * s_shared;
        for (int r = 0; r < rect_h; ++r) {
            const float l = (float)(ry_min + r) * (float)s.tile_h - my;
            const float u = l + (float)(s.tile_h - 1);
            const float lo_d = t_max(l, -dy_lim);
            const float hi_d = t_min(u, dy_lim);
            const float dyc = t_min(t_max(dy_star, lo_d), hi_d);
            const float D1 = t_clamp_min(taus * ca - (detc * dyc) * dyc, 0.0f);
            const float xmax_e = (-cb * dyc + sqrtf(D1)) * inv_a;
            const float dyc2 = t_min(t_max(-dy_star, lo_d), hi_d);
            const float D2 = t_clamp_min(taus * ca - (detc * dyc2) * dyc2, 0.0f);
            const float xmin_e = (-cb * dyc2 - sqrtf(D2)) * inv_a;
            const float dyn = t_min(t_clamp_min(l, 0.0f), u);
            const float rem = r_cut * r_cut - dyn * dyn;
            const float xc = sqrtf(t_clamp_min(rem, 0.0f)) + F(0.05);
            const float xmax = t_min(xmax_e + F(0.05), xc);
            const float xmin = t_max(xmin_e - F(0.05), -xc);
            int lo = to_int32(ceilf(((mx + xmin) - (float)(s.tile_w - 1)) * inv_tw));
            int hi = to_int32(floorf((mx + xmax) * inv_tw));
            lo = lo > rx_min ? lo : rx_min;
            hi = hi < rx_max - 1 ? hi : rx_max - 1;
            const bool row_ok = lo_d <= hi_d && rem >= 0.0f && xmin <= xmax;
            const int span = row_ok && hi - lo + 1 > 0 ? hi - lo + 1 : 0;
            x0[r] = span > 0 ? lo : 0;
            total += span;
            cum[r] = total;
        }
        for (int r = rect_h; r < SPAN_ROWS; ++r) {
            x0[r] = 0;
            cum[r] = total;
        }
        is_span = total < SPAN_LIMIT && rx_max <= SPAN_LIMIT;
    }
    if (!is_span) {
        for (int r = 0; r < SPAN_ROWS; ++r) {
            x0[r] = 0;
            cum[r] = 0;
        }
    }
    int tiles = is_span ? total : (rect_w > 0 ? rect_w : 0) * (rect_h > 0 ? rect_h : 0);
    tiles = op_cut * 255.0f > 1.0f ? tiles : 0;
    const bool valid = in_front && det_ok && tiles > 0;
    tiles = valid ? tiles : 0;

    // blend_fields
    fields[0] = mx;
    fields[1] = my;
    fields[2] = ca;
    fields[3] = cb;
    fields[4] = cc;
    fields[5] = op_cut;
    fields[6] = rgb[0];
    fields[7] = rgb[1];
    fields[8] = rgb[2];
    fields[9] = 1.0f / (valid ? depth : 1.0f);
    // the radii and build_table's columns
    row.radius = to_int32(valid ? radius_f : 0.0f);
    row.rect_x0 = rx_min;
    row.rect_y0 = ry_min;
    row.rect_w = rect_w > 1 ? rect_w : 1;
    row.span_flag = is_span ? 1 : 0;
    row.count = tiles > 0 ? tiles : 1;
    row.depth_key = tiles > 0 && valid ? depth : BIG;
}

// ---- the kernel

struct Params {
    const float* means3d;        // (P, 3)
    const float* scales;         // (P, 3) log-scales
    const float* quats;          // (P, 4) wxyz, not normalised
    const float* opacities;      // (P,) logits
    const uint8_t* alive;        // (P,) bool
    const float* features_dc;    // (P, 1, 3)
    const float* features_rest;  // (P, rest_k, 3)
    const float* viewmatrix;     // (4, 4)
    const float* projmatrix;     // (4, 4)
    const float* campos;         // (3,)
    int P, rest_k, active_degree;
    Scalars s;
    float* fields;               // (P, 10)
    int32_t* radii;              // (P,)
    int32_t* rect_x0;
    int32_t* rect_y0;
    int32_t* rect_w;
    int32_t* span_flag;
    int32_t* span_x0;            // (P, 16)
    int32_t* span_cum;           // (P, 16)
    float* depth_key;            // (P,)
    int64_t* slots;              // (P + 1,) 0, then the slots each Gaussian owns:
                                 // tiles touched, or one sentinel
};

// Rows [0, n) of ``len`` floats from contiguous global memory into shared
// memory at row stride ``stride``: 16-byte loads where the source allows,
// consecutive threads on consecutive words.
__device__ void stage_rows(float* dst, const float* __restrict__ src, int n, int len,
                           int stride) {
    const int total = n * len;
    int head = 0;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        head = total & ~3;
        for (int i = 4 * threadIdx.x; i < head; i += 4 * THREADS) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(src + i));
            const float w[4] = {v.x, v.y, v.z, v.w};
            int r = i / len, c = i - r * len;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                dst[r * stride + c] = w[k];
                if (++c == len) {
                    c = 0;
                    ++r;
                }
            }
        }
    }
    for (int i = head + threadIdx.x; i < total; i += THREADS) {
        const int r = i / len;
        dst[r * stride + (i - r * len)] = __ldg(src + i);
    }
}

// The converse: staged rows out to contiguous global memory, 16-byte
// stores where the destination allows.
template <typename T>
__device__ void unstage_rows(T* __restrict__ dst, const T* src, int n, int len, int stride) {
    const int total = n * len;
    int head = 0;
    if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
        head = total & ~3;
        for (int i = 4 * threadIdx.x; i < head; i += 4 * THREADS) {
            T w[4];
            int r = i / len, c = i - r * len;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                w[k] = src[r * stride + c];
                if (++c == len) {
                    c = 0;
                    ++r;
                }
            }
            *reinterpret_cast<float4*>(dst + i) = *reinterpret_cast<const float4*>(w);
        }
    }
    for (int i = head + threadIdx.x; i < total; i += THREADS) {
        const int r = i / len;
        dst[i] = src[r * stride + (i - r * len)];
    }
}

template <int D>
__global__ void __launch_bounds__(THREADS) project_kernel(const Params p) {
    extern __shared__ float smem[];
    const int rest_len = D > 0 ? 3 * p.rest_k : 0;
    const int rest_stride = rest_len | 1;
    float* cam = smem;  // view 0..15, projection 16..31, centre 32..34
    float* s_means = smem + CAM_FLOATS;
    float* s_scales = s_means + 3 * THREADS;
    float* s_dc = s_scales + 3 * THREADS;
    float* s_rest = s_dc + 3 * THREADS;  // then the output rows
    float* o_fields = s_rest;
    int* o_x0 = reinterpret_cast<int*>(o_fields + FIELDS_STRIDE * THREADS);
    int* o_cum = o_x0 + SPAN_STRIDE * THREADS;

    const int start = blockIdx.x * THREADS;
    const int n = min(THREADS, p.P - start);
    const int t = threadIdx.x;
    if (t < 16) {
        cam[t] = __ldg(p.viewmatrix + t);
        cam[16 + t] = __ldg(p.projmatrix + t);
    }
    if (t < 3) cam[32 + t] = __ldg(p.campos + t);
    stage_rows(s_means, p.means3d + (size_t)3 * start, n, 3, 3);
    stage_rows(s_scales, p.scales + (size_t)3 * start, n, 3, 3);
    stage_rows(s_dc, p.features_dc + (size_t)3 * start, n, 3, 3);
    if (D > 0) stage_rows(s_rest, p.features_rest + (size_t)rest_len * start, n, rest_len,
                          rest_stride);
    __syncthreads();

    const bool live = t < n;
    float rgb[3];
    if (live) sh_color<D>(s_means + 3 * t, cam + 32, s_dc + 3 * t, s_rest + rest_stride * t,
                          p.active_degree, rgb);
    __syncthreads();  // the SH rows are read: their space takes the output rows

    if (live) {
        const int g = start + t;
        float q[4];
        if ((reinterpret_cast<uintptr_t>(p.quats) & 15) == 0) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(p.quats) + g);
            q[0] = v.x;
            q[1] = v.y;
            q[2] = v.z;
            q[3] = v.w;
        } else {
            for (int k = 0; k < 4; ++k) q[k] = __ldg(p.quats + (size_t)4 * g + k);
        }
        Row row;
        project_geometry(s_means + 3 * t, s_scales + 3 * t, q, __ldg(p.opacities + g),
                         p.alive[g] != 0, rgb, cam, cam + 16, p.s,
                         o_fields + FIELDS_STRIDE * t, o_x0 + SPAN_STRIDE * t,
                         o_cum + SPAN_STRIDE * t, row);
        p.radii[g] = row.radius;
        p.rect_x0[g] = row.rect_x0;
        p.rect_y0[g] = row.rect_y0;
        p.rect_w[g] = row.rect_w;
        p.span_flag[g] = row.span_flag;
        p.depth_key[g] = row.depth_key;
        p.slots[g + 1] = row.count;
        if (g == 0) p.slots[0] = 0;
    }
    __syncthreads();
    unstage_rows(p.fields + (size_t)NUM_FIELDS * start, o_fields, n, NUM_FIELDS, FIELDS_STRIDE);
    unstage_rows(p.span_x0 + (size_t)SPAN_ROWS * start, o_x0, n, SPAN_ROWS, SPAN_STRIDE);
    unstage_rows(p.span_cum + (size_t)SPAN_ROWS * start, o_cum, n, SPAN_ROWS, SPAN_STRIDE);
}

template <int D>
int launch(const Params& p, cudaStream_t stream) {
    const int rest_stride = D > 0 ? (3 * p.rest_k) | 1 : 0;
    const int big = rest_stride > OUT_FLOATS ? rest_stride : OUT_FLOATS;
    const size_t smem = sizeof(float) * (CAM_FLOATS + 9 * THREADS + (size_t)big * THREADS);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            project_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int blocks = (p.P + THREADS - 1) / THREADS;
    project_kernel<D><<<blocks, THREADS, smem, stream>>>(p);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gs_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

int gs_project(const void* means3d, const void* scales, const void* quats,
               const void* opacities, const void* alive, const void* features_dc,
               const void* features_rest, const void* viewmatrix, const void* projmatrix,
               const void* campos, int P, int rest_k, int sh_degree, int active_degree,
               int antialiasing, int width, int height, int tile_w, int tile_h,
               float scale_modifier, float limx, float limy, float fx, float fy,
               void* fields, void* radii, void* rect_x0, void* rect_y0, void* rect_w,
               void* span_flag, void* span_x0, void* span_cum, void* depth_key,
               void* slots, void* stream) {
    if (P <= 0) return (int)cudaMemsetAsync(slots, 0, sizeof(int64_t), (cudaStream_t)stream);
    Params p;
    p.means3d = (const float*)means3d;
    p.scales = (const float*)scales;
    p.quats = (const float*)quats;
    p.opacities = (const float*)opacities;
    p.alive = (const uint8_t*)alive;
    p.features_dc = (const float*)features_dc;
    p.features_rest = (const float*)features_rest;
    p.viewmatrix = (const float*)viewmatrix;
    p.projmatrix = (const float*)projmatrix;
    p.campos = (const float*)campos;
    p.P = P;
    p.rest_k = rest_k;
    p.active_degree = active_degree;
    p.s.scale_modifier = scale_modifier;
    p.s.limx = limx;
    p.s.limy = limy;
    p.s.fx = fx;
    p.s.fy = fy;
    p.s.width = width;
    p.s.height = height;
    p.s.grid_x = (width + tile_w - 1) / tile_w;
    p.s.grid_y = (height + tile_h - 1) / tile_h;
    p.s.tile_w = tile_w;
    p.s.tile_h = tile_h;
    p.s.antialiasing = antialiasing;
    p.fields = (float*)fields;
    p.radii = (int32_t*)radii;
    p.rect_x0 = (int32_t*)rect_x0;
    p.rect_y0 = (int32_t*)rect_y0;
    p.rect_w = (int32_t*)rect_w;
    p.span_flag = (int32_t*)span_flag;
    p.span_x0 = (int32_t*)span_x0;
    p.span_cum = (int32_t*)span_cum;
    p.depth_key = (float*)depth_key;
    p.slots = (int64_t*)slots;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (sh_degree) {
        case 0: return launch<0>(p, s);
        case 1: return launch<1>(p, s);
        case 2: return launch<2>(p, s);
        case 3: return launch<3>(p, s);
        case 4: return launch<4>(p, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
