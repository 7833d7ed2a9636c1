// Fused stride-1 3x3 (dilated) conv + folded eval-BN affine + optional
// residual add + activation, NHWC activations and HWIO weights.
//
// Replaces: mcmda_tpu/kernels/fused_conv.py, conv_bn_act_pallas (the Pallas
// TPU kernel behind segmenter.apply_fused_eval).  Computes exactly what
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
// few bytes.  This first version runs f32 FMAs on the CUDA cores, so its
// ceiling is the card's f32 (non-tensor-core) rate, not the bf16 tensor-core
// rate.
//
// Design: an implicit GEMM.  Rows are output pixels (M = N*H*W), columns are
// output channels (K), the reduction runs over 9 taps x C.  One block owns a
// 64-pixel x 64-channel output tile and walks the reduction in steps of one
// tap x 16 input channels: each step gathers the shifted input tile (zero
// where the tap falls outside the image, so no padded copy of x is ever
// written) and the matching weight slice into shared memory, then every
// thread accumulates a 4x4 register tile from them.  The BN affine, residual
// and activation are applied to the registers before the single store, so
// the conv output never round-trips through device memory.  Unlike the TPU
// kernel there is no VMEM-sized K tiling or fits-in-VMEM gate: the tile is
// fixed and ragged edges (C=3 stem, K=16, M not a multiple of 64) are masked,
// so every shape runs.  wgmma / TMA / bf16 tensor-core payloads are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;                                   // pixels per block
constexpr int BN = 64;                                   // channels per block
constexpr int BK = 16;                                   // reduction step
constexpr int TM = 4;                                    // pixels per thread
constexpr int TN = 4;                                    // channels per thread
constexpr int THREADS = (BM / TM) * (BN / TN);           // 256
constexpr int A_ROWS = THREADS / BK;                     // 16 pixels per pass
constexpr int A_PASSES = BM / A_ROWS;                    // 4
constexpr int B_ROWS = THREADS / BN;                     // 4 channels per pass
constexpr int B_PASSES = BK / B_ROWS;                    // 4
constexpr int A_PAD = 4;  // keeps the transposed A stores off one bank

enum Activation { kNone = 0, kRelu = 1, kLeakyRelu = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TX, typename TR>
__global__ void __launch_bounds__(THREADS)
conv_bn_act_kernel(const TX* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, const TR* __restrict__ res,
                   float* __restrict__ out, int n_img, int h, int wd, int c,
                   int k, int dil, int act) {
  __shared__ __align__(16) float As[BK][BM + A_PAD];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int hw = h * wd;
  const int m_total = n_img * hw;

  // A loader: 16 consecutive threads read 16 consecutive channels of one
  // pixel (NHWC keeps them contiguous), A_ROWS pixels per pass.
  const int a_c = tid % BK;
  const int a_r = tid / BK;
  int pix_img[A_PASSES], pix_y[A_PASSES], pix_x[A_PASSES];
#pragma unroll
  for (int i = 0; i < A_PASSES; ++i) {
    const int m = m0 + a_r + i * A_ROWS;
    if (m < m_total) {
      pix_img[i] = m / hw;
      const int rem = m - pix_img[i] * hw;
      pix_y[i] = rem / wd;
      pix_x[i] = rem - pix_y[i] * wd;
    } else {
      pix_img[i] = -1;
      pix_y[i] = 0;
      pix_x[i] = 0;
    }
  }
  // B loader: 64 consecutive threads read 64 consecutive output channels
  // of one (tap, input channel) row of the HWIO weights.
  const int b_n = tid % BN;
  const int b_r = tid / BN;

  // compute mapping: thread owns pixels tm..tm+3 and channels tn..tn+3
  const int tm = (tid / (BN / TN)) * TM;
  const int tn = (tid % (BN / TN)) * TN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = (tap / 3 - 1) * dil;
    const int dx = (tap % 3 - 1) * dil;
    for (int c0 = 0; c0 < c; c0 += BK) {
      const int ca = c0 + a_c;
#pragma unroll
      for (int i = 0; i < A_PASSES; ++i) {
        float v = 0.f;
        const int iy = pix_y[i] + dy;
        const int ix = pix_x[i] + dx;
        if (pix_img[i] >= 0 && ca < c && iy >= 0 && iy < h && ix >= 0 &&
            ix < wd) {
          v = to_f32(x[((static_cast<size_t>(pix_img[i]) * h + iy) * wd + ix) *
                           c + ca]);
        }
        As[a_c][a_r + i * A_ROWS] = v;
      }
      const int kb = n0 + b_n;
#pragma unroll
      for (int i = 0; i < B_PASSES; ++i) {
        const int cb = c0 + b_r + i * B_ROWS;
        Bs[b_r + i * B_ROWS][b_n] =
            (cb < c && kb < k)
                ? w[(static_cast<size_t>(tap) * c + cb) * k + kb]
                : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&As[kk][tm]);
        const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tn]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // epilogue: folded BN affine, residual, activation, one f32 store
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm + i;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int kk = n0 + tn + j;
      if (kk >= k) continue;
      const size_t o = static_cast<size_t>(m) * k + kk;
      float y = acc[i][j] * scale[kk] + bias[kk];
      if (res != nullptr) y += to_f32(res[o]);
      if (act == kRelu) {
        y = fmaxf(y, 0.f);
      } else if (act == kLeakyRelu) {
        y = y >= 0.f ? y : 0.2f * y;
      }
      out[o] = y;
    }
  }
}

template <typename TX, typename TR>
void launch(const void* x, const void* w, const void* scale, const void* bias,
            const void* res, void* out, int n, int h, int wd, int c, int k,
            int dil, int act, cudaStream_t stream) {
  const int m_total = n * h * wd;
  const dim3 grid((m_total + BM - 1) / BM, (k + BN - 1) / BN);
  conv_bn_act_kernel<TX, TR><<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const TR*>(res), static_cast<float*>(out), n, h, wd, c, k,
      dil, act);
}

}  // namespace

// Plain C entry point (bound with ctypes).  x_bf16 / res_bf16 select the
// element type of x and of the residual (0 = f32, 1 = bf16); res may be null.
// act: 0 none, 1 relu, 2 leaky relu (0.2).  Launches on `stream` without
// synchronising and returns cudaGetLastError() (0 on success).
extern "C" int mcmda_conv_bn_act(const void* x, int x_bf16, const void* w,
                                 const void* scale, const void* bias,
                                 const void* res, int res_bf16, void* out,
                                 int n, int h, int wd, int c, int k, int dil,
                                 int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    if (res_bf16) {
      launch<__nv_bfloat16, __nv_bfloat16>(x, w, scale, bias, res, out, n, h,
                                           wd, c, k, dil, act, s);
    } else {
      launch<__nv_bfloat16, float>(x, w, scale, bias, res, out, n, h, wd, c,
                                   k, dil, act, s);
    }
  } else {
    if (res_bf16) {
      launch<float, __nv_bfloat16>(x, w, scale, bias, res, out, n, h, wd, c,
                                   k, dil, act, s);
    } else {
      launch<float, float>(x, w, scale, bias, res, out, n, h, wd, c, k, dil,
                           act, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
