// Bilinear affine warp of a packed NHWC batch (image channels, then one-hot
// label channels), with the label renormalisation folded in.
//
// Replaces: mcmda_tpu/kernels/warp.py, warp_affine_nchw (the Pallas TPU
// kernel behind pipeline.augment_batch / augment_images under
// data.warp="pallas").  Computes what warp_affine_reference computes: for
// output pixel (y, x) of image b with coefficients c = coefs[b],
//   ys = c0*y + c1*x + c2,  xs = c3*y + c4*x + c5
// (rotate / zoom / shift about the centre, a horizontal flip folded into
// c3..c5); outside 0 <= ys <= H-1, 0 <= xs <= W-1 every channel is 0, else
// the 4-corner bilinear blend of the edge-clamped corners
// (floor(ys), floor(xs)) .. (+1, +1).  Channels at index >= n_image are
// then divided by max(sum of those channels, 1e-6).  f32 in, f32 out.
//
// What bounds it on an H100: memory.  Per output pixel it reads 4 corners x
// C floats (mostly from L1/L2: neighbouring outputs share corners) and
// writes C floats; a 8 x 256 x 256 x 8 batch is 2 MB out.
//
// Design: one thread per output pixel, reading and writing NHWC directly, so
// no layout transposes are needed.  The TPU kernel recast the warp as banded
// MXU matmuls because the TPU has no fast gather; a GPU gathers, so that
// form (and its band_bound / tile_width sizing) is not carried over.  The
// sampling coordinates are computed with FMA contraction off, in the plain
// version's operation order, so they are bitwise equal to it: a pixel whose
// ys lies within rounding of 0 or H-1 would otherwise flip the validity
// mask, an O(1) error.  Unlike the TPU kernel (bf16 MXU payload) the blend
// is f32.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
warp_affine_kernel(const float* __restrict__ img,
                   const float* __restrict__ coefs, float* __restrict__ out,
                   int b, int h, int w, int c, int n_image) {
  const size_t plane = static_cast<size_t>(h) * w;
  const size_t p = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (p >= static_cast<size_t>(b) * plane) return;
  const int bi = static_cast<int>(p / plane);
  const int rem = static_cast<int>(p - static_cast<size_t>(bi) * plane);
  const float y = static_cast<float>(rem / w);
  const float x = static_cast<float>(rem % w);
  const float* cf = coefs + static_cast<size_t>(bi) * 6;
  // (c0*y + c1*x) + c2, each step rounded, as the plain version's tensor ops
  const float ys =
      __fadd_rn(__fadd_rn(__fmul_rn(cf[0], y), __fmul_rn(cf[1], x)), cf[2]);
  const float xs =
      __fadd_rn(__fadd_rn(__fmul_rn(cf[3], y), __fmul_rn(cf[4], x)), cf[5]);
  float* o = out + p * c;
  const bool valid = ys >= 0.f && ys <= static_cast<float>(h - 1) &&
                     xs >= 0.f && xs <= static_cast<float>(w - 1);
  if (!valid) {
    for (int ch = 0; ch < c; ++ch) o[ch] = 0.f;
    return;
  }
  const float y0 = floorf(ys);
  const float x0 = floorf(xs);
  const float wy = ys - y0;
  const float wx = xs - x0;
  const int y0c = min(max(static_cast<int>(y0), 0), h - 1);
  const int x0c = min(max(static_cast<int>(x0), 0), w - 1);
  const int y1c = min(y0c + 1, h - 1);
  const int x1c = min(x0c + 1, w - 1);
  const float* base = img + static_cast<size_t>(bi) * plane * c;
  const float* g00 = base + (static_cast<size_t>(y0c) * w + x0c) * c;
  const float* g01 = base + (static_cast<size_t>(y0c) * w + x1c) * c;
  const float* g10 = base + (static_cast<size_t>(y1c) * w + x0c) * c;
  const float* g11 = base + (static_cast<size_t>(y1c) * w + x1c) * c;
  const float w00 = (1.f - wy) * (1.f - wx);
  const float w01 = (1.f - wy) * wx;
  const float w10 = wy * (1.f - wx);
  const float w11 = wy * wx;
  float label_sum = 0.f;
  for (int ch = 0; ch < c; ++ch) {
    const float v =
        w00 * g00[ch] + w01 * g01[ch] + w10 * g10[ch] + w11 * g11[ch];
    o[ch] = v;
    if (ch >= n_image) label_sum += v;
  }
  if (n_image < c) {
    const float denom = fmaxf(label_sum, 1e-6f);
    for (int ch = n_image; ch < c; ++ch) o[ch] = o[ch] / denom;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  img [b,h,w,c] f32, coefs [b,6]
// f32, out [b,h,w,c] f32; channels >= n_image are renormalised.  Launches on
// `stream` without synchronising and returns cudaGetLastError().
extern "C" int mcmda_warp_affine(const void* img, const void* coefs, void* out,
                                 int b, int h, int w, int c, int n_image,
                                 void* stream) {
  const size_t pixels = static_cast<size_t>(b) * h * w;
  const unsigned blocks = static_cast<unsigned>((pixels + THREADS - 1) / THREADS);
  warp_affine_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(coefs),
      static_cast<float*>(out), b, h, w, c, n_image);
  return static_cast<int>(cudaGetLastError());
}
