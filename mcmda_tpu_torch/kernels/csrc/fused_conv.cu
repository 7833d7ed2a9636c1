// Fused stride-1 3x3 (dilated) conv + folded eval-BN affine + optional
// residual add + activation, NHWC activations and HWIO weights.
//
// Replaces: mcmda_tpu/kernels/fused_conv.py, conv_bn_act_pallas (the Pallas
// TPU kernel behind segmenter.apply_fused_eval).  Computes what
// conv_bn_act_reference computes off the TPU: for every output element the
// sum over 9 taps x C of x (zero outside the image, i.e. XLA SAME padding of
// `dilation` on each side) times w, accumulated in f32, then `* scale + bias`,
// `+ residual` when given, and relu / leaky relu (0.2) / none.  x and the
// residual may be f32 or bf16 and are widened to f32 on load; w, scale and
// bias are f32; the output is always f32.
//
// What bounds it on an H100: the serving path's heavy calls are the 1/8
// resolution tail (32x32 planes, 256-512 channels, 9*C up to 4608 terms per
// output), which is compute-bound: ~2*9*C FLOPs per output element against a
// few bytes.  The conv runs in split TF32 on the tensor cores (three TF32
// products per f32 product, two for a bf16 x), so its ceiling is 495/3 = 165
// TFLOP/s of f32-accurate work, not the 67 TFLOP/s of the CUDA cores.
//
// Design: the implicit GEMM of conv_tile.cuh, on one of its two loops
// (conv_tile::plan, by shape): the Hopper loop (TMA + wgmma, 128 x 128 or
// 128 x 64 tiles) for f32 x with C % 32 == 0, K % 64 == 0 and whole-row
// pixel tiles -- every 1/8-resolution tail site and rm2 / rm3 -- after a
// pre-pass that splits the weights into K-major TF32 hi / lo arrays; the
// mma.sync loop (cp.async ring, 128-pixel tiles 16-128 channels wide) for
// the rest.  The BN affine, residual and activation are applied to the
// accumulator fragments, and each thread stores its two adjacent channels
// of a row as one float2, so the conv output never round-trips through
// device memory.  Unlike the TPU kernel there is no VMEM-sized K tiling or
// fits-in-VMEM gate: ragged edges (C=3 stem, K=16, M not a multiple of
// 128) are masked on the mma.sync loop, so every shape runs.

#include "conv_tile.cuh"

namespace {

using namespace conv_tile;

enum Activation { kNone = 0, kRelu = 1, kLeakyRelu = 2 };

__device__ __forceinline__ float load_res(const void* res, int res_bf16,
                                          size_t o) {
  return res_bf16 ? __bfloat162float(
                        static_cast<const __nv_bfloat16*>(res)[o])
                  : static_cast<const float*>(res)[o];
}

// y + residual[o] (when given), then the activation.
__device__ __forceinline__ float finish(float y, const void* res,
                                        int res_bf16, size_t o, int act) {
  if (res != nullptr) y += load_res(res, res_bf16, o);
  if (act == kRelu) return fmaxf(y, 0.f);
  if (act == kLeakyRelu) return y >= 0.f ? y : 0.2f * y;
  return y;
}

template <typename TX, class T>
__global__ void __launch_bounds__(THREADS, 1)
conv_bn_act_kernel(const TX* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, const void* __restrict__ res,
                   int res_bf16, float* __restrict__ out, int n_img, int h,
                   int wd, int c, int k, int dil, int act) {
  using L = MainLoop<TX, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * T::BN;
  const int m_total = n_img * h * wd;
  float acc[T::MT][T::NT][4];
  L::run(x, w, n_img, h, wd, c, k, dil, m0, n0, smem, acc);

  // epilogue: folded BN affine, residual, activation, one f32 store per
  // pair of adjacent channels
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool pairs = k % 2 == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt) {
    const int col = n0 + L::frag_col(warp, lane, nt);
    if (col >= k) continue;
    const bool two = col + 1 < k;
    const float s0 = scale[col], b0 = bias[col];
    const float s1 = two ? scale[col + 1] : 0.f;
    const float b1 = two ? bias[col + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + L::frag_row(warp, lane, mt, half);
        if (m >= m_total) continue;
        const size_t o = static_cast<size_t>(m) * k + col;
        const float y0 =
            finish(acc[mt][nt][2 * half] * s0 + b0, res, res_bf16, o, act);
        const float y1 = two ? finish(acc[mt][nt][2 * half + 1] * s1 + b1, res,
                                      res_bf16, o + 1, act)
                             : 0.f;
        if (pairs) {
          *reinterpret_cast<float2*>(out + o) = make_float2(y0, y1);
        } else {
          out[o] = y0;
          if (two) out[o + 1] = y1;
        }
      }
    }
  }
}

// The Hopper loop's kernel (conv_tile::hopper): the same epilogue on the
// wgmma accumulator layout; K is a multiple of BN and M of BM, so no mask.
template <int BN>
__global__ void __launch_bounds__(hopper::THREADS, 1)
conv_bn_act_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap hi_map,
                   const __grid_constant__ CUtensorMap lo_map,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, const void* __restrict__ res,
                   int res_bf16, float* __restrict__ out, int h, int wd, int c,
                   int k, int dil, int act) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Lp = hopper::Loop<BN>;
  Lp::run(smem, &xmap, &hi_map, &lo_map, h, wd, c, dil,
          [&](float (&acc)[Lp::ACC], int row, int col0) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const int col = col0 + 8 * j;
              const float s0 = scale[col], s1 = scale[col + 1];
              const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const size_t o = static_cast<size_t>(row + 8 * half) * k + col;
                const float y0 = finish(acc[4 * j + 2 * half] * s0 + b0, res,
                                        res_bf16, o, act);
                const float y1 = finish(acc[4 * j + 2 * half + 1] * s1 + b1,
                                        res, res_bf16, o + 1, act);
                *reinterpret_cast<float2*>(out + o) = make_float2(y0, y1);
              }
            }
          });
}

template <typename TX, class T>
cudaError_t launch(const void* x, const void* w, const void* scale,
                   const void* bias, const void* res, int res_bf16, void* out,
                   int n, int h, int wd, int c, int k, int dil, int act,
                   cudaStream_t stream) {
  auto kernel = conv_bn_act_kernel<TX, T>;
  const size_t smem = MainLoop<TX, T>::SMEM_BYTES;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(m_tiles(n * h * wd), (k + T::BN - 1) / T::BN);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias), res,
      res_bf16, static_cast<float*>(out), n, h, wd, c, k, dil, act);
  return cudaGetLastError();
}

template <typename TX>
size_t smem_bytes(int bn) {
  switch (bn) {
    case 16: return MainLoop<TX, Tile16>::SMEM_BYTES;
    case 32: return MainLoop<TX, Tile32>::SMEM_BYTES;
    case 64: return MainLoop<TX, Tile64>::SMEM_BYTES;
    default: return MainLoop<TX, Tile128>::SMEM_BYTES;
  }
}

template <typename TX>
cudaError_t launch_tile(const void* x, const void* w, const void* scale,
                        const void* bias, const void* res, int res_bf16,
                        void* out, int n, int h, int wd, int c, int k, int dil,
                        int act, int bn, cudaStream_t s) {
  switch (bn) {
    case 16:
      return launch<TX, Tile16>(x, w, scale, bias, res, res_bf16, out, n, h,
                                wd, c, k, dil, act, s);
    case 32:
      return launch<TX, Tile32>(x, w, scale, bias, res, res_bf16, out, n, h,
                                wd, c, k, dil, act, s);
    case 64:
      return launch<TX, Tile64>(x, w, scale, bias, res, res_bf16, out, n, h,
                                wd, c, k, dil, act, s);
    default:
      return launch<TX, Tile128>(x, w, scale, bias, res, res_bf16, out, n, h,
                                 wd, c, k, dil, act, s);
  }
}

// The Hopper loop: the tensor maps and the weight pre-pass, then the conv.
template <int BN>
cudaError_t launch_wgmma(const void* x, const void* w, void* w_hi, void* w_lo,
                         const void* scale, const void* bias, const void* res,
                         int res_bf16, void* out, int n, int h, int wd, int c,
                         int k, int dil, int act, const Plan& p,
                         cudaStream_t stream) {
  hopper::Maps maps;
  cudaError_t err =
      prepare_wgmma(&maps, x, w, w_hi, w_lo, n, h, wd, c, k, p, stream);
  if (err != cudaSuccess) return err;
  auto kernel = conv_bn_act_kernel<BN>;
  const size_t smem = hopper::Layout<BN>::smem_bytes(0);
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.grid_x, p.grid_y), hopper::THREADS, smem, stream>>>(
      maps.x, maps.w_hi, maps.w_lo, static_cast<const float*>(scale),
      static_cast<const float*>(bias), res, res_bf16, static_cast<float*>(out),
      h, wd, c, k, dil, act);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  x_bf16 / res_bf16 select the
// element type of x and of the residual (0 = f32, 1 = bf16); res may be null.
// act: 0 none, 1 relu, 2 leaky relu (0.2).  w_hi / w_lo are the Hopper
// loop's scratch, two f32 [k, 9c] arrays, needed where mcmda_conv_plan says
// loop 1 (else they may be null).  Launches on `stream` without
// synchronising and returns the first CUDA error (0 on success).
extern "C" int mcmda_conv_bn_act(const void* x, int x_bf16, const void* w,
                                 void* w_hi, void* w_lo, const void* scale,
                                 const void* bias, const void* res,
                                 int res_bf16, void* out, int n, int h, int wd,
                                 int c, int k, int dil, int act,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = plan(n, h, wd, c, k, x_bf16 != 0, device_sms());
  cudaError_t err;
  if (p.loop == kWgmma) {
    err = p.bn == 128
              ? launch_wgmma<128>(x, w, w_hi, w_lo, scale, bias, res, res_bf16,
                                  out, n, h, wd, c, k, dil, act, p, s)
              : launch_wgmma<64>(x, w, w_hi, w_lo, scale, bias, res, res_bf16,
                                 out, n, h, wd, c, k, dil, act, p, s);
  } else {
    err = x_bf16 ? launch_tile<__nv_bfloat16>(x, w, scale, bias, res,
                                              res_bf16, out, n, h, wd, c, k,
                                              dil, act, p.bn, s)
                 : launch_tile<float>(x, w, scale, bias, res, res_bf16, out, n,
                                      h, wd, c, k, dil, act, p.bn, s);
  }
  return static_cast<int>(err);
}

// The plan of a conv of x [n, h, wd, c] (bf16 where x_bf16) to k channels on
// a card of `sms` SMs, as conv_tile::plan gives it to both conv kernels:
// out[0..5] = loop (0 mma.sync, 1 Hopper), channels per block, the Hopper
// loop's A box rows and columns (0 on the mma.sync loop), grid x (pixel
// tiles) and grid y (channel tiles).  Returns 0.
extern "C" int mcmda_conv_plan(int n, int h, int wd, int c, int k, int x_bf16,
                               int sms, int* out) {
  const Plan p = plan(n, h, wd, c, k, x_bf16 != 0, sms);
  const int fields[6] = {p.loop, p.bn, p.box_h, p.box_w, p.grid_x, p.grid_y};
  for (int i = 0; i < 6; ++i) out[i] = fields[i];
  return 0;
}

// The Hopper loop's weight pre-pass alone (what both conv entry points run
// first on that loop): w [3,3,c,k] f32 -> w_hi, w_lo [k, 9c] f32.
// Launches on `stream` and returns the launch's CUDA error.
extern "C" int mcmda_split_weights(const void* w, void* w_hi, void* w_lo,
                                   int c, int k, void* stream) {
  return static_cast<int>(split_weights(w, w_hi, w_lo, c, k,
                                        static_cast<cudaStream_t>(stream)));
}

// The dynamic shared memory (bytes) of mcmda_conv_bn_act's mma.sync-loop
// launch for an output of m pixels and k channels (the conv + moments
// kernel of train_conv.cu adds 2 * 4 * BN * WARPS_M bytes for its
// moments).
extern "C" int mcmda_conv_smem_bytes(int x_bf16, int m, int k) {
  const int bn = tile_width(pick_tile(m, k, device_sms()));
  return static_cast<int>(x_bf16 ? smem_bytes<__nv_bfloat16>(bn)
                                 : smem_bytes<float>(bn));
}
