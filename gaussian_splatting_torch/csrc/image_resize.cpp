// Bilinear resize of an 8-bit HWC image on the host, as the JAX package's
// loader resizes training images: gaussian_splatting_tpu/native/
// gs_native.cpp::image_resize_bilinear_u8, copied here so that the port's
// loader gives the same pixels without importing that package.  Two taps a
// side with align_corners=false and pixel-centre sampling, in double, then a
// clamp to 0..255 and lround (half away from zero).
//
// Built with that library's compiler and flags (g++ -O3 -march=native), by
// gaussian_splatting_torch/_kernels.py::host_library.  The flags matter: on a
// CPU with FMA, g++ contracts the products and sums below into fused
// multiply-adds, which round once where the plain expression rounds twice,
// and near a half that moves the result by one level.  A numpy transcription
// of the expression differs from this build on about 6 values in 100,000
// (tests/test_torch_image_resize.py).

#include <algorithm>
#include <cmath>
#include <cstdint>

extern "C" int image_resize_bilinear_u8(const uint8_t* in, long long ih, long long iw,
                                        long long c, uint8_t* out, long long oh,
                                        long long ow) {
  if (ih <= 0 || iw <= 0 || oh <= 0 || ow <= 0 || c <= 0) return -1;
  const double sy = (double)ih / oh;
  const double sx = (double)iw / ow;
  for (long long y = 0; y < oh; y++) {
    double fy = (y + 0.5) * sy - 0.5;
    long long y0 = (long long)floor(fy);
    double wy = fy - y0;
    long long y1 = y0 + 1;
    y0 = std::max(0LL, std::min(ih - 1, y0));
    y1 = std::max(0LL, std::min(ih - 1, y1));
    for (long long x = 0; x < ow; x++) {
      double fx = (x + 0.5) * sx - 0.5;
      long long x0 = (long long)floor(fx);
      double wx = fx - x0;
      long long x1 = x0 + 1;
      x0 = std::max(0LL, std::min(iw - 1, x0));
      x1 = std::max(0LL, std::min(iw - 1, x1));
      const uint8_t* p00 = in + (y0 * iw + x0) * c;
      const uint8_t* p01 = in + (y0 * iw + x1) * c;
      const uint8_t* p10 = in + (y1 * iw + x0) * c;
      const uint8_t* p11 = in + (y1 * iw + x1) * c;
      uint8_t* o = out + (y * ow + x) * c;
      for (long long k = 0; k < c; k++) {
        double v = (1 - wy) * ((1 - wx) * p00[k] + wx * p01[k]) +
                   wy * ((1 - wx) * p10[k] + wx * p11[k]);
        o[k] = (uint8_t)std::lround(std::min(255.0, std::max(0.0, v)));
      }
    }
  }
  return 0;
}
