// K2: the landmark nets' 3x3 stride-2 stem on 2x2 space-to-depth packed
// crops.
//
// Replaces: bp_from_video_tpu/pallas/stem_kernel.py `stem_packed`
// (pallas_call at :136, body `_stem_kernel` at :59).
//
// What it computes, per crop and output pixel (y, x) of the half-size grid:
//   acc[co] = sum over taps t = (dy, dx, c), in that order, of
//             plane[(dy%2)*2 + dx%2][c](y + dy/2, x + dx/2) * w[co][t]
//   out[co] = PReLU_alpha(acc[co] + b[co])        (alpha 0 = ReLU)
// A stride-2 tap of the original image is a packed plane at a unit shift,
// zero where the index reaches the grid's far edge (TFLite SAME at even
// sizes pads lo = 0, hi = 1).  Inputs are read in their type, weights, bias
// and alpha are f32, accumulation is f32 in tap order with separately
// rounded multiply and add, so the plain version matches bit for bit; the
// output has the input's type.
//
// Bound on this card: bytes (at most 27 taps x cout multiply-adds per
// 2*(12 + cout) bytes moved: ~10 flops per byte).  Design: one thread per
// output pixel gathers its taps into registers once (each packed plane is
// read by neighbouring threads at neighbouring addresses) and loops over
// the output channels with the weights in shared memory (every thread of a
// warp reads the same weight: a broadcast); a warp's stores of one channel
// are contiguous.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define THREADS 256
#define MAX_TAPS 27

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
stem_packed_kernel(const T* __restrict__ crops, const float* __restrict__ wmat,
                   const float* __restrict__ bias,
                   const float* __restrict__ alpha, T* __restrict__ out,
                   int cin, int cout, int k, int half) {
  extern __shared__ float ws[];          // [cout][ntaps], then bias, alpha
  const int ntaps = k * k * cin;
  float* bs = ws + cout * ntaps;
  float* as = bs + cout;
  for (int e = threadIdx.x; e < cout * ntaps; e += THREADS) ws[e] = wmat[e];
  for (int e = threadIdx.x; e < cout; e += THREADS) {
    bs[e] = bias[e];
    as[e] = alpha[e];
  }
  __syncthreads();
  const int hw = half * half;
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= hw) return;
  const int y = p / half, x = p - y * half;
  const T* cb = crops + (long long)blockIdx.y * 4 * cin * hw;
  float win[MAX_TAPS];
#pragma unroll
  for (int t = 0; t < MAX_TAPS; ++t) {
    float v = 0.0f;
    if (t < ntaps) {
      const int c = t % cin, dx = (t / cin) % k, dy = t / (cin * k);
      const int yy = y + (dy >> 1), xx = x + (dx >> 1);
      if (yy < half && xx < half)
        v = ld<T>(cb + (long long)(((dy & 1) * 2 + (dx & 1)) * cin + c) * hw +
                  yy * half + xx);
    }
    win[t] = v;
  }
  T* ob = out + (long long)blockIdx.y * cout * hw + p;
  for (int co = 0; co < cout; ++co) {
    const float* w = ws + co * ntaps;
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < MAX_TAPS; ++t)
      if (t < ntaps) acc = __fadd_rn(acc, __fmul_rn(win[t], w[t]));
    float v = __fadd_rn(acc, bs[co]);
    v = v >= 0.0f ? v : __fmul_rn(v, as[co]);
    ob[(long long)co * hw] = st_cvt<T>(v);
  }
}

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// crops: [B, 4*cin, half, half] (f32 or bf16, `in_bf16`); wmat: f32
// [cout, k*k*cin], taps in (dy, dx, c) order; bias, alpha: f32 [cout];
// out: [B, cout, half, half] in the input type.  k*k*cin <= 27.
int stem_packed_launch(const void* crops, const void* wmat, const void* bias,
                       const void* alpha, void* out, int b, int cin, int cout,
                       int k, int half, int in_bf16, void* stream) {
  if (k * k * cin > MAX_TAPS) return (int)cudaErrorInvalidValue;
  dim3 grid((half * half + THREADS - 1) / THREADS, b);
  const size_t smem = (size_t)(cout * k * k * cin + 2 * cout) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (in_bf16) {
    stem_packed_kernel<__nv_bfloat16><<<grid, THREADS, smem, st>>>(
        (const __nv_bfloat16*)crops, (const float*)wmat, (const float*)bias,
        (const float*)alpha, (__nv_bfloat16*)out, cin, cout, k, half);
  } else {
    stem_packed_kernel<float><<<grid, THREADS, smem, st>>>(
        (const float*)crops, (const float*)wmat, (const float*)bias,
        (const float*)alpha, (float*)out, cin, cout, k, half);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
