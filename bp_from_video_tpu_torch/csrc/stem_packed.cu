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
// Bound on this card: bytes for the function (at most 27 taps x cout
// multiply-adds per 2*(12 + cout) bytes moved), but bit-equality forbids the
// fused multiply-add and the tensor cores: every tap of every output is one
// FMUL and one FADD, 2 * 27 * cout instructions a pixel, and at the
// flagship shapes executing them takes longer than moving the bytes.  So the
// design spends as few other instructions as it can beside them:
//  - a thread computes a run of RUN = 8 neighbouring pixels of one output
//    row for a tile of CO_T = 8 output channels, its 64 sums in registers;
//    the tap loop is outside, the channel and pixel loops inside, so each
//    tap's 8 inputs and 8 weights feed 64 multiply-adds;
//  - the weights are in shared memory as [channel tile][tap][8], two
//    16-byte broadcast loads a tap (every lane reads the same address).
//    `__constant__` memory would drop even those, but one symbol is shared
//    by every launch of the library, so two launches with other weights on
//    two streams would race for it; shared memory keeps the launch
//    self-contained at 2 loads per 128 arithmetic instructions;
//  - a run's inputs are one 16-byte load (bf16; two for f32) per tap where
//    the row allows (half a multiple of 8 and 16-byte aligned operands: the
//    flagship's 128 and 112), else scalar loads; a tap shifted by one
//    column takes the aligned load and one more element;
//  - outputs go out as one 16-byte store per channel and run (bf16; two for
//    f32) where aligned, else scalar stores with a ragged tail;
//  - the grid is the blocks the card holds at once (2 an SM at 128
//    registers a thread), each thread walking the batch's runs one grid
//    apart: with one block per 256 runs, the hand stem's 896 blocks would
//    fill 3.4 waves of the 264 resident ones, the last less than half.
// Channel tiles past cout have zero weights and are not stored.  Neither a
// loop of taps unrolled for the 3x3x3 stem nor the next tap's load started
// ahead of this tap's arithmetic was faster on the card.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define THREADS 256
#define MAX_TAPS 27
#define RUN 8       // output pixels of one row per thread
#define CO_T 8      // output channels per register tile

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

static_assert(RUN == 8 && CO_T % 4 == 0, "16-byte runs, float4 weights");

// A run's 8 inputs from a 16-byte aligned address.
__device__ __forceinline__ void ld_run(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void ld_run(const __nv_bfloat16* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// A run's 8 outputs to a 16-byte aligned address.
__device__ __forceinline__ void st_run(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void st_run(__nv_bfloat16* p, const float* v) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    u[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
stem_packed_kernel(const T* __restrict__ crops, const float* __restrict__ wmat,
                   const float* __restrict__ bias,
                   const float* __restrict__ alpha, T* __restrict__ out,
                   int nb, int cin, int cout, int k, int half, int vec) {
  // [tile][tap][CO_T] weights, zero past cout; then bias, alpha per tile.
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);
  const int ntaps = k * k * cin;
  const int ntiles = (cout + CO_T - 1) / CO_T;
  float* bs = ws + ntiles * ntaps * CO_T;
  float* as = bs + ntiles * CO_T;
  for (int e = threadIdx.x; e < ntiles * ntaps * CO_T; e += THREADS) {
    const int j = e % CO_T, t = (e / CO_T) % ntaps;
    const int co = (e / (CO_T * ntaps)) * CO_T + j;
    ws[e] = co < cout ? wmat[co * ntaps + t] : 0.0f;
  }
  for (int e = threadIdx.x; e < ntiles * CO_T; e += THREADS) {
    bs[e] = e < cout ? bias[e] : 0.0f;
    as[e] = e < cout ? alpha[e] : 0.0f;
  }
  __syncthreads();
  const int runs = (half + RUN - 1) / RUN;
  const int hw = half * half;
  const int per_crop = half * runs;
  // A thread walks the batch's runs one grid of resident blocks apart.
  for (long long u = (long long)blockIdx.x * THREADS + threadIdx.x;
       u < (long long)nb * per_crop; u += (long long)gridDim.x * THREADS) {
    const int crop = (int)(u / per_crop);
    const int g = (int)(u - (long long)crop * per_crop);
    const int y = g / runs;
    const int x0 = (g - y * runs) * RUN;
    const T* cb = crops + (long long)crop * 4 * cin * hw;
    T* ob = out + (long long)crop * cout * hw + y * half + x0;
    for (int tile = 0; tile < ntiles; ++tile) {
      float acc[CO_T][RUN];
#pragma unroll
      for (int j = 0; j < CO_T; ++j)
#pragma unroll
        for (int p = 0; p < RUN; ++p) acc[j][p] = 0.0f;
      const float4* wt =
          reinterpret_cast<const float4*>(ws + tile * ntaps * CO_T);
      for (int dy = 0; dy < k; ++dy) {
        const int yy = y + (dy >> 1);
        for (int dx = 0; dx < k; ++dx) {
          const int sx = dx >> 1;
          for (int c = 0; c < cin; ++c, wt += CO_T / 4) {
            const T* row =
                cb + (((dy & 1) * 2 + (dx & 1)) * cin + c) * hw + yy * half;
            float v[RUN];
            if (yy >= half) {               // the far edge's zero padding
#pragma unroll
              for (int p = 0; p < RUN; ++p) v[p] = 0.0f;
            } else if (vec) {
              ld_run(row + x0, v);
              if (sx) {                     // one column to the right
#pragma unroll
                for (int p = 0; p < RUN - 1; ++p) v[p] = v[p + 1];
                v[RUN - 1] = x0 + RUN < half ? ld1(row + x0 + RUN) : 0.0f;
              }
            } else {
#pragma unroll
              for (int p = 0; p < RUN; ++p)
                v[p] = x0 + sx + p < half ? ld1(row + x0 + sx + p) : 0.0f;
            }
            float w[CO_T];
#pragma unroll
            for (int q = 0; q < CO_T / 4; ++q) {
              const float4 w4 = wt[q];
              w[4 * q] = w4.x; w[4 * q + 1] = w4.y;
              w[4 * q + 2] = w4.z; w[4 * q + 3] = w4.w;
            }
#pragma unroll
            for (int j = 0; j < CO_T; ++j)
#pragma unroll
              for (int p = 0; p < RUN; ++p)
                acc[j][p] = __fadd_rn(acc[j][p], __fmul_rn(v[p], w[j]));
          }
        }
      }
#pragma unroll
      for (int j = 0; j < CO_T; ++j) {
        const int co = tile * CO_T + j;
        if (co >= cout) break;
        const float b = bs[co], a = as[co];
        float v[RUN];
#pragma unroll
        for (int p = 0; p < RUN; ++p) {
          const float s = __fadd_rn(acc[j][p], b);
          v[p] = s >= 0.0f ? s : __fmul_rn(s, a);
        }
        T* o = ob + (long long)co * hw;
        if (vec) {
          st_run(o, v);
        } else {
#pragma unroll
          for (int p = 0; p < RUN; ++p)
            if (x0 + p < half) st1(o + p, v[p]);
        }
      }
    }
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
  const int ntiles = (cout + CO_T - 1) / CO_T;
  const size_t smem =
      (size_t)ntiles * CO_T * (k * k * cin + 2) * sizeof(float);
  // One block for every slot the launch bounds hold resident (registers
  // allow 2 a SM), at most one a THREADS runs.
  const long long units = (long long)b * half * ((half + RUN - 1) / RUN);
  if (units == 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = (units + THREADS - 1) / THREADS;
  const int grid = (int)(need < 2LL * sms ? need : 2LL * sms);
  // 16-byte runs: whole runs in every row, every row 16-byte aligned.
  const int vec = half % RUN == 0 && (uintptr_t)crops % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (in_bf16) {
    stem_packed_kernel<__nv_bfloat16><<<grid, THREADS, smem, st>>>(
        (const __nv_bfloat16*)crops, (const float*)wmat, (const float*)bias,
        (const float*)alpha, (__nv_bfloat16*)out, b, cin, cout, k, half, vec);
  } else {
    stem_packed_kernel<float><<<grid, THREADS, smem, st>>>(
        (const float*)crops, (const float*)wmat, (const float*)bias,
        (const float*)alpha, (float*)out, b, cin, cout, k, half, vec);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
