// K3: one stride-2 blaze block (or the 3x3/2 stem) as an implicit GEMM on
// 2x2 space-to-depth packed input.
//
// Replaces: bp_from_video_tpu/pallas/block_kernel.py `dense_s2_block`
// (pallas_call in `_block_call` at :180, body `_block_kernel` at :67);
// `trunk_apply` (:559) chains four of these.
//
// What it computes, per crop b:
//   acc[O, p] = W'[O, K] @ windows[K, p]   (p over the h*w output pixels)
// where the windows are the packed planes shifted by (0,0)/(0,1)/(1,0)/(1,1)
// (zero past the far edge: TFLite SAME pads lo=0, hi=1 at even sizes), in
// the "sliced" (K = 9*cin) or "expanded" (K = 4*rup8(4*cin)) row order of
// `pack_block_weights`.  Epilogue: + bias, then either the residual flavor
// (max of the four parity planes = the 2x2 maxpool, added to the first cin
// channels, channel zero-pad, ReLU) or the stem flavor ([P]ReLU, alpha 0 =
// ReLU).  Like the TPU kernel, weights and windows are bf16 whatever the
// input type (windows are rounded to bf16), accumulation is f32, and the
// output has the input's type.
//
// Bound on this card: bytes.  At the flagship shapes a block does 70-270
// flops per byte it must move, under the ~295 at which bf16 tensor cores
// would become the limit.  This first version does plain f32 FMA (products
// of bf16 values are exact in f32), so it is far from that bound: it is
// limited by the FMA rate and by building the window tile (integer index
// math per element); tensor cores and a TMA-fed tile ring come later.  Design: one block
// per (crop, 32 output channels, 128 output pixels); the K loop stages a
// 32-deep slice of W' and of the window matrix in shared memory, building
// the window slice straight from the packed input (never materialized in
// device memory); each thread accumulates a 4x4 (channel x pixel) tile in
// registers; ragged channel/pixel edges (hw = 49, 64, ...) are masked.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define CO_T 32
#define P_T 128
#define KC 32
#define THREADS 256

template <typename T>
__device__ __forceinline__ float ld(const T* p);
template <>
__device__ __forceinline__ float ld<float>(const float* p) { return *p; }
template <>
__device__ __forceinline__ float ld<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__device__ __forceinline__ T st_cvt(float v);
template <>
__device__ __forceinline__ float st_cvt<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 st_cvt<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dense_s2_block_kernel(const T* __restrict__ x,
                      const __nv_bfloat16* __restrict__ wmat,
                      const float* __restrict__ bias,
                      const float* __restrict__ alpha, T* __restrict__ out,
                      int cin, int cout, int h, int w, int kdim, int expanded,
                      int resid) {
  __shared__ __align__(16) float ws[KC][CO_T];
  __shared__ float xs[KC][P_T];
  const int bi = blockIdx.z;
  const int co0 = blockIdx.y * CO_T;
  const int p0 = blockIdx.x * P_T;
  const int hw = h * w;
  const int tid = threadIdx.x;
  const int ty = tid >> 5;   // 8 channel groups of 4
  const int tx = tid & 31;   // 32 pixel lanes, 4 pixels each (stride 32)
  const T* xb = x + (long long)bi * 4 * cin * hw;
  const int pad = ((4 * cin + 7) / 8) * 8;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < kdim; k0 += KC) {
    for (int e = tid; e < CO_T * KC; e += THREADS) {
      const int kk = e % KC, co = e / KC;
      float v = 0.0f;
      if (co0 + co < cout && k0 + kk < kdim)
        v = __bfloat162float(wmat[(long long)(co0 + co) * kdim + k0 + kk]);
      ws[kk][co] = v;
    }
    for (int e = tid; e < KC * P_T; e += THREADS) {
      const int pp = e % P_T, kk = e / P_T;
      const int k = k0 + kk, p = p0 + pp;
      float v = 0.0f;
      if (k < kdim && p < hw) {
        int src, g;
        if (expanded) {
          g = k / pad;
          const int r = k - g * pad;
          src = r < 4 * cin ? r : -1;
        } else {
          const int t = k / cin, c = k - t * cin;
          const int dy = t / 3, dx = t - 3 * (t / 3);
          g = (dy >> 1) * 2 + (dx >> 1);
          src = ((dy & 1) * 2 + (dx & 1)) * cin + c;
        }
        if (src >= 0) {
          const int yy = p / w + (g >> 1);
          const int xx = p - (p / w) * w + (g & 1);
          if (yy < h && xx < w)
            v = to_bf16(ld<T>(xb + (long long)src * hw + yy * w + xx));
        }
      }
      xs[kk][pp] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&ws[kk][ty * 4]);
      float bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = xs[kk][tx + 32 * j];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[0][j] += a.x * bv[j];
        acc[1][j] += a.y * bv[j];
        acc[2][j] += a.z * bv[j];
        acc[3][j] += a.w * bv[j];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = co0 + ty * 4 + i;
    if (co >= cout) continue;
    const float bco = bias[co];
    const float aco = alpha != nullptr ? alpha[co] : 0.0f;  // null: ReLU
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx + 32 * j;
      if (p >= hw) continue;
      float v = acc[i][j] + bco;
      if (resid) {
        if (co < cin) {
          float m = ld<T>(xb + (long long)co * hw + p);
#pragma unroll
          for (int q = 1; q < 4; ++q)
            m = fmaxf(m, ld<T>(xb + (long long)(q * cin + co) * hw + p));
          v += m;
        }
        v = fmaxf(v, 0.0f);
      } else {
        v = v >= 0.0f ? v : v * aco;
      }
      out[((long long)bi * cout + co) * hw + p] = st_cvt<T>(v);
    }
  }
}

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x: [B, 4*cin, h, w] (f32 or bf16, `in_bf16`); wmat: bf16 [cout, kdim];
// bias: f32 [cout]; alpha: f32 [cout] or null (ReLU); out: [B, cout, h, w]
// in the input type.
int dense_s2_block_launch(const void* x, const void* wmat, const void* bias,
                          const void* alpha, void* out, int b, int cin,
                          int cout, int h, int w, int kdim, int expanded,
                          int resid, int in_bf16, void* stream) {
  dim3 grid((h * w + P_T - 1) / P_T, (cout + CO_T - 1) / CO_T, b);
  cudaStream_t st = (cudaStream_t)stream;
  if (in_bf16) {
    dense_s2_block_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)wmat,
        (const float*)bias, (const float*)alpha, (__nv_bfloat16*)out, cin,
        cout, h, w, kdim, expanded, resid);
  } else {
    dense_s2_block_kernel<float><<<grid, THREADS, 0, st>>>(
        (const float*)x, (const __nv_bfloat16*)wmat, (const float*)bias,
        (const float*)alpha, (float*)out, cin, cout, h, w, kdim, expanded,
        resid);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
