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
// What bounds it on an H100: memory.  Every input and output byte moves
// once (a 8 x 256 x 256 x 8 batch is 16.8 MB each way) for about 80
// operations per pixel, so what counts is how many load and store
// transactions the bytes cost: four corners per output pixel, mostly
// served by L1 because neighbouring outputs share them.
//
// Design.  The TPU kernel recast the warp as banded MXU matmuls because the
// TPU has no fast gather; a GPU gathers, so that form (and its band_bound /
// tile_width sizing) is not carried over.
// - A block makes a two-dimensional tile of output pixels, so that under
//   rotation its source footprint is a compact patch whose lines L1 serves,
//   not a long slanted strip.
// - All of a pixel's values live in registers: blend, label sum, divide,
//   then one store of each value.  No kernel reads `out`.
// - The path's channel counts are compile-time: at (C, n_image) = (8, 3) a
//   pixel is 32 aligned bytes, read through the read-only path as one float4
//   per corner by each of the two lanes that share a pixel (the label sum
//   is completed by one shuffle and a warp's store instruction writes 512
//   contiguous bytes); at (3, 3) a pixel is 12
//   bytes, so a thread makes one pixel with scalar loads and the block
//   stages its tile in shared memory and writes each tile row as float4s.
//   Every other shape, and a tensor that is not 16-byte aligned, takes the
//   generic kernel: one thread per pixel, run-time C, two passes over the
//   corners (label sum, then blend + divide + store).
// - Arithmetic: the sampling coordinates, the corner weights and the blend
//   are computed with round-to-nearest intrinsics that the compiler may not
//   contract into FMAs, in the plain version's operation order
//   ((c0*y + c1*x) + c2; (1-wy)*(1-wx) ..; ((t00 + t01) + t10) + t11).  The
//   validity mask and the image channels are therefore bitwise the plain
//   version's; only the label sum's order (and so the renormalised labels'
//   last bits) may differ.  Unlike the TPU kernel (bf16 MXU payload) the
//   blend is f32.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int VEC_C = 8;  // channels of the float4 kernel: two quads a pixel
// output tiles, in pixels (on an H100 the tile's shape moved the time by
// under 3%): the float4 kernel's, two lanes a pixel, and the other two's
constexpr int VEC_TILE_W = 16;
constexpr int VEC_TILE_H = 8;
constexpr int TILE_W = 32;
constexpr int TILE_H = 8;

// Where output pixel (yo, xo) samples its image: the four corners as pixel
// offsets within the image, and their weights.
struct Sample {
  bool valid;
  int o00, o01, o10, o11;
  float w00, w01, w10, w11;
};

__device__ __forceinline__ Sample sample_at(const float* __restrict__ cf,
                                            int yo, int xo, int h, int w) {
  const float y = static_cast<float>(yo);
  const float x = static_cast<float>(xo);
  // (c0*y + c1*x) + c2, each step rounded, as the plain version's tensor ops
  const float ys = __fadd_rn(
      __fadd_rn(__fmul_rn(__ldg(cf + 0), y), __fmul_rn(__ldg(cf + 1), x)),
      __ldg(cf + 2));
  const float xs = __fadd_rn(
      __fadd_rn(__fmul_rn(__ldg(cf + 3), y), __fmul_rn(__ldg(cf + 4), x)),
      __ldg(cf + 5));
  Sample s;
  s.valid = ys >= 0.f && ys <= static_cast<float>(h - 1) && xs >= 0.f &&
            xs <= static_cast<float>(w - 1);
  const float y0 = floorf(ys);
  const float x0 = floorf(xs);
  const float wy = __fsub_rn(ys, y0);
  const float wx = __fsub_rn(xs, x0);
  const float my = __fsub_rn(1.f, wy);
  const float mx = __fsub_rn(1.f, wx);
  s.w00 = __fmul_rn(my, mx);
  s.w01 = __fmul_rn(my, wx);
  s.w10 = __fmul_rn(wy, mx);
  s.w11 = __fmul_rn(wy, wx);
  // the clamps only matter where !valid, whose offsets are never read
  const int y0c = min(max(static_cast<int>(y0), 0), h - 1);
  const int x0c = min(max(static_cast<int>(x0), 0), w - 1);
  const int y1c = min(y0c + 1, h - 1);
  const int x1c = min(x0c + 1, w - 1);
  s.o00 = y0c * w + x0c;
  s.o01 = y0c * w + x1c;
  s.o10 = y1c * w + x0c;
  s.o11 = y1c * w + x1c;
  return s;
}

// ((w00*g00 + w01*g01) + w10*g10) + w11*g11, every product and sum rounded
__device__ __forceinline__ float blend(const Sample& s, float g00, float g01,
                                       float g10, float g11) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(s.w00, g00), __fmul_rn(s.w01, g01)),
                __fmul_rn(s.w10, g10)),
      __fmul_rn(s.w11, g11));
}

// C = 8: two lanes share a pixel, each holding one of its two float4 quads.
// img and out are 16-byte aligned.
template <int NI>
__global__ void __launch_bounds__(VEC_TILE_W * VEC_TILE_H * 2)
warp_vec_kernel(const float4* __restrict__ img,
                const float* __restrict__ coefs, float4* __restrict__ out,
                int h, int w) {
  constexpr int QUADS = VEC_C / 4;
  const int pi = threadIdx.x / QUADS;
  const int quad = threadIdx.x % QUADS;
  const int xo = blockIdx.x * VEC_TILE_W + pi % VEC_TILE_W;
  const int yo = blockIdx.y * VEC_TILE_H + pi / VEC_TILE_W;
  const size_t first = static_cast<size_t>(blockIdx.z) * h * w;
  const bool inside = xo < w && yo < h;
  const Sample s = sample_at(coefs + 6 * blockIdx.z, yo, xo, h, w);
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (inside && s.valid) {
    const float4* p = img + first * QUADS + quad;
    const float4 a = __ldg(p + static_cast<size_t>(s.o00) * QUADS);
    const float4 b = __ldg(p + static_cast<size_t>(s.o01) * QUADS);
    const float4 c = __ldg(p + static_cast<size_t>(s.o10) * QUADS);
    const float4 d = __ldg(p + static_cast<size_t>(s.o11) * QUADS);
    v[0] = blend(s, a.x, b.x, c.x, d.x);
    v[1] = blend(s, a.y, b.y, c.y, d.y);
    v[2] = blend(s, a.z, b.z, c.z, d.z);
    v[3] = blend(s, a.w, b.w, c.w, d.w);
  }
  float label_sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) label_sum += quad * 4 + i >= NI ? v[i] : 0.f;
  // every lane reaches the shuffle: nothing above returns
  label_sum += __shfl_xor_sync(0xffffffffu, label_sum, 1);
  const float denom = fmaxf(label_sum, 1e-6f);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (quad * 4 + i >= NI) v[i] = v[i] / denom;
  if (inside)
    out[(first + static_cast<size_t>(yo) * w + xo) * QUADS + quad] =
        make_float4(v[0], v[1], v[2], v[3]);
}

// A small compile-time C that is no multiple of 4 (the path's 3): one
// thread per pixel, the tile staged in shared memory and written row by
// row, as float4s when `vec` (W % 4 == 0 and out 16-byte aligned: then
// every tile row starts on 16 bytes and holds whole float4s).
template <int C, int NI>
__global__ void __launch_bounds__(TILE_W * TILE_H)
warp_staged_kernel(const float* __restrict__ img,
                   const float* __restrict__ coefs, float* __restrict__ out,
                   int h, int w, int vec) {
  constexpr int THREADS = TILE_W * TILE_H;
  constexpr int ROW = TILE_W * C;  // floats of one tile row
  static_assert(TILE_W % 4 == 0, "tile rows must hold whole float4s");
  __shared__ __align__(16) float tile[TILE_H * ROW];
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const int xo = x0 + threadIdx.x % TILE_W;
  const int yo = y0 + threadIdx.x / TILE_W;
  const size_t first = static_cast<size_t>(blockIdx.z) * h * w;
  const Sample s = sample_at(coefs + 6 * blockIdx.z, yo, xo, h, w);
  float v[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) v[ch] = 0.f;
  if (xo < w && yo < h && s.valid) {
    const float* p = img + first * C;
    const float* g00 = p + static_cast<size_t>(s.o00) * C;
    const float* g01 = p + static_cast<size_t>(s.o01) * C;
    const float* g10 = p + static_cast<size_t>(s.o10) * C;
    const float* g11 = p + static_cast<size_t>(s.o11) * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      v[ch] = blend(s, __ldg(g00 + ch), __ldg(g01 + ch), __ldg(g10 + ch),
                    __ldg(g11 + ch));
  }
  if (NI < C) {
    float label_sum = 0.f;
#pragma unroll
    for (int ch = NI; ch < C; ++ch) label_sum += v[ch];
    const float denom = fmaxf(label_sum, 1e-6f);
#pragma unroll
    for (int ch = NI; ch < C; ++ch) v[ch] = v[ch] / denom;
  }
#pragma unroll
  for (int ch = 0; ch < C; ++ch) tile[threadIdx.x * C + ch] = v[ch];
  // zeroed, outside and tail threads all reach the barrier
  __syncthreads();
  const int row_valid = min(TILE_W, w - x0) * C;  // floats inside W
  float* o = out + (first + static_cast<size_t>(y0) * w + x0) * C;
  const size_t pitch = static_cast<size_t>(w) * C;
  if (vec) {
    for (int i = threadIdx.x; i < TILE_H * ROW / 4; i += THREADS) {
      const int r = i / (ROW / 4);
      const int j = i % (ROW / 4);
      if (y0 + r < h && j * 4 < row_valid)
        reinterpret_cast<float4*>(o + r * pitch)[j] =
            reinterpret_cast<const float4*>(tile)[i];
    }
  } else {
    for (int i = threadIdx.x; i < TILE_H * ROW; i += THREADS) {
      const int r = i / ROW;
      const int j = i % ROW;
      if (y0 + r < h && j < row_valid) o[r * pitch + j] = tile[i];
    }
  }
}

// Any C and n_image: one thread per pixel, two passes over the corners.
__global__ void __launch_bounds__(TILE_W * TILE_H)
warp_generic_kernel(const float* __restrict__ img,
                    const float* __restrict__ coefs, float* __restrict__ out,
                    int h, int w, int c, int n_image) {
  const int xo = blockIdx.x * TILE_W + threadIdx.x % TILE_W;
  const int yo = blockIdx.y * TILE_H + threadIdx.x / TILE_W;
  if (xo >= w || yo >= h) return;
  const size_t first = static_cast<size_t>(blockIdx.z) * h * w;
  const Sample s = sample_at(coefs + 6 * blockIdx.z, yo, xo, h, w);
  float* o = out + (first + static_cast<size_t>(yo) * w + xo) * c;
  if (!s.valid) {
    for (int ch = 0; ch < c; ++ch) o[ch] = 0.f;
    return;
  }
  const float* p = img + first * c;
  const float* g00 = p + static_cast<size_t>(s.o00) * c;
  const float* g01 = p + static_cast<size_t>(s.o01) * c;
  const float* g10 = p + static_cast<size_t>(s.o10) * c;
  const float* g11 = p + static_cast<size_t>(s.o11) * c;
  float label_sum = 0.f;
  for (int ch = n_image; ch < c; ++ch)
    label_sum += blend(s, __ldg(g00 + ch), __ldg(g01 + ch), __ldg(g10 + ch),
                       __ldg(g11 + ch));
  const float denom = fmaxf(label_sum, 1e-6f);
  for (int ch = 0; ch < c; ++ch) {
    const float v = blend(s, __ldg(g00 + ch), __ldg(g01 + ch),
                          __ldg(g10 + ch), __ldg(g11 + ch));
    o[ch] = ch >= n_image ? v / denom : v;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

dim3 tiles(int b, int h, int w, int tile_w, int tile_h) {
  return dim3((w + tile_w - 1) / tile_w, (h + tile_h - 1) / tile_h, b);
}

}  // namespace

// Plain C entry point (bound with ctypes).  img [b,h,w,c] f32, coefs [b,6]
// f32, out [b,h,w,c] f32; channels >= n_image are renormalised.  b and the
// number of tile rows (h / 8) are grid dimensions, at most 65535 each.
// Launches on `stream` without synchronising and returns cudaGetLastError()
// (cudaErrorInvalidValue for a grid that does not fit).
extern "C" int mcmda_warp_affine(const void* img, const void* coefs, void* out,
                                 int b, int h, int w, int c, int n_image,
                                 void* stream) {
  const float* imgf = static_cast<const float*>(img);
  const float* cf = static_cast<const float*>(coefs);
  float* outf = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b < 1 || b > 65535 || h < 1 || w < 1 ||
      (h + TILE_H - 1) / TILE_H > 65535 ||
      (h + VEC_TILE_H - 1) / VEC_TILE_H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c == VEC_C && n_image == 3 && aligned16(img) && aligned16(out)) {
    warp_vec_kernel<3>
        <<<tiles(b, h, w, VEC_TILE_W, VEC_TILE_H),
           VEC_TILE_W * VEC_TILE_H * 2, 0, s>>>(
            static_cast<const float4*>(img), cf, static_cast<float4*>(out), h,
            w);
  } else if (c == 3 && n_image == 3) {
    warp_staged_kernel<3, 3>
        <<<tiles(b, h, w, TILE_W, TILE_H), TILE_W * TILE_H, 0, s>>>(
            imgf, cf, outf, h, w, w % 4 == 0 && aligned16(out) ? 1 : 0);
  } else {
    warp_generic_kernel<<<tiles(b, h, w, TILE_W, TILE_H),
                          TILE_W * TILE_H, 0, s>>>(
        imgf, cf, outf, h, w, c, n_image);
  }
  return static_cast<int>(cudaGetLastError());
}
