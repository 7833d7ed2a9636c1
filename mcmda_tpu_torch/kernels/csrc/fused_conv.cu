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
// Design: the implicit GEMM of conv_tile.cuh (128-pixel tiles, 16-128
// channels wide, cp.async ring, mma.sync m16n8k8).  The BN affine, residual
// and activation are applied to the accumulator fragments, and each thread
// stores its two adjacent channels of a row as one float2, so the conv
// output never round-trips through device memory.  Unlike the TPU kernel
// there is no VMEM-sized K tiling or fits-in-VMEM gate: ragged edges (C=3
// stem, K=16, M not a multiple of 128) are masked, so every shape runs.
// wgmma and TMA are later work.

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
        float y0 = acc[mt][nt][2 * half] * s0 + b0;
        float y1 = acc[mt][nt][2 * half + 1] * s1 + b1;
        if (res != nullptr) {
          y0 += load_res(res, res_bf16, o);
          if (two) y1 += load_res(res, res_bf16, o + 1);
        }
        if (act == kRelu) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        } else if (act == kLeakyRelu) {
          y0 = y0 >= 0.f ? y0 : 0.2f * y0;
          y1 = y1 >= 0.f ? y1 : 0.2f * y1;
        }
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
size_t smem_bytes(int m, int k) {
  switch (pick_tile(m, k)) {
    case kTile16: return MainLoop<TX, Tile16>::SMEM_BYTES;
    case kTile32: return MainLoop<TX, Tile32>::SMEM_BYTES;
    case kTile64: return MainLoop<TX, Tile64>::SMEM_BYTES;
    default: return MainLoop<TX, Tile128>::SMEM_BYTES;
  }
}

template <typename TX>
cudaError_t launch_tile(const void* x, const void* w, const void* scale,
                        const void* bias, const void* res, int res_bf16,
                        void* out, int n, int h, int wd, int c, int k, int dil,
                        int act, cudaStream_t s) {
  switch (pick_tile(n * h * wd, k)) {
    case kTile16:
      return launch<TX, Tile16>(x, w, scale, bias, res, res_bf16, out, n, h,
                                wd, c, k, dil, act, s);
    case kTile32:
      return launch<TX, Tile32>(x, w, scale, bias, res, res_bf16, out, n, h,
                                wd, c, k, dil, act, s);
    case kTile64:
      return launch<TX, Tile64>(x, w, scale, bias, res, res_bf16, out, n, h,
                                wd, c, k, dil, act, s);
    default:
      return launch<TX, Tile128>(x, w, scale, bias, res, res_bf16, out, n, h,
                                 wd, c, k, dil, act, s);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  x_bf16 / res_bf16 select the
// element type of x and of the residual (0 = f32, 1 = bf16); res may be null.
// act: 0 none, 1 relu, 2 leaky relu (0.2).  Launches on `stream` without
// synchronising and returns the launch's CUDA error (0 on success).
extern "C" int mcmda_conv_bn_act(const void* x, int x_bf16, const void* w,
                                 const void* scale, const void* bias,
                                 const void* res, int res_bf16, void* out,
                                 int n, int h, int wd, int c, int k, int dil,
                                 int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_bf16 ? launch_tile<__nv_bfloat16>(x, w, scale, bias, res, res_bf16,
                                          out, n, h, wd, c, k, dil, act, s)
             : launch_tile<float>(x, w, scale, bias, res, res_bf16, out, n, h,
                                  wd, c, k, dil, act, s);
  return static_cast<int>(err);
}

// The dynamic shared memory (bytes) of mcmda_conv_bn_act's launch for an
// output of m pixels and k channels (the conv + moments kernel of
// train_conv.cu adds 2 * 4 * BN * WARPS_M bytes for its moments).
extern "C" int mcmda_conv_smem_bytes(int x_bf16, int m, int k) {
  return static_cast<int>(x_bf16 ? smem_bytes<__nv_bfloat16>(m, k)
                                 : smem_bytes<float>(m, k));
}
