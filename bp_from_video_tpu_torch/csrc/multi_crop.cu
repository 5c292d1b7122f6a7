// K1: fused multi-crop bilinear resample (axis-aligned cover crops).
//
// Replaces: bp_from_video_tpu/pallas/warp_kernel.py `multi_crop`
// (pallas_call at :127, body `_kernel` at :30).
//
// What it computes: for every stream s and crop c, the crop of rect
// (cx, cy, w, h) at `size`^2 as `wy @ plane @ wx.T` per channel, with the
// zero-pad triangle weights max(0, 1 - |sample - pixel|); a NaN rect gives a
// zero crop; `scale` is folded in; pack=2 emits the 2x2 space-to-depth
// planes (channel (a*2+b)*3 + ch, pixel (i, j) = crop (2i+a, 2j+b)).
//
// Rounding follows the TPU kernel exactly: weights are rounded to the
// operand type (bf16 or f32), the row-pass value `tmp` is rounded to the
// operand type before the column pass, both passes accumulate in f32, then
// `* scale` and the cast to the output type.  A triangle row has at most two
// nonzero taps, so each output element needs the row pass at only two
// frame columns: the kernel evaluates those taps directly instead of the
// dense [size, H] @ [H, W] products.  With bf16 operands every product is
// exact in f32 and a two-term sum rounds once, so the result is bit-equal to
// the dense version; sample coordinates use explicit round-to-nearest
// intrinsics so that no multiply-add is contracted.
//
// Bound on this card: bytes.  Per output element it does ~20 flops and
// reads at most 4 frame bytes (from L1/L2 — neighbouring outputs share
// them), so the floor is the frame bytes under the crops plus the output
// written once.  Design: one thread per output element, consecutive threads
// on consecutive output columns (coalesced 2-byte stores), all crops of all
// streams in ONE launch (grid.y = crop, grid.z = stream).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MAX_CROPS 8

struct CropSet {
  int n;
  int size[MAX_CROPS];
  int pack[MAX_CROPS];
  int per_stream[MAX_CROPS];        // 3 * p*p * (size/p)^2
  long long offset[MAX_CROPS];      // element offset of crop c's block
};

__device__ __forceinline__ float round_op(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// Sample coordinate of crop pixel `idx` (exactly the TPU kernel's f32 op
// order: ((idx + 0.5) / size - 0.5), then center + u * extent - 0.5).
__device__ __forceinline__ float sample_at(int idx, int size, float center,
                                           float extent) {
  float u = __fsub_rn(__fdiv_rn(__fadd_rn((float)idx, 0.5f), (float)size),
                      0.5f);
  return __fsub_rn(__fadd_rn(center, __fmul_rn(u, extent)), 0.5f);
}

__device__ __forceinline__ float tri(float s, int g, int bf16) {
  float d = fabsf(__fsub_rn(s, (float)g));
  return round_op(fmaxf(0.0f, __fsub_rn(1.0f, d)), bf16);
}

template <typename OutT>
__device__ __forceinline__ OutT cvt_out(float v);
template <>
__device__ __forceinline__ float cvt_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 cvt_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void multi_crop_kernel(const uint8_t* __restrict__ frames,
                                  const float* __restrict__ rects,
                                  OutT* __restrict__ out, CropSet cs,
                                  int h, int w, float scale, int op_bf16) {
  const int c = blockIdx.y;
  const int s = blockIdx.z;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cs.n || e >= cs.per_stream[c]) return;
  const int size = cs.size[c];
  const int p = cs.pack[c];
  const int n2 = size / p;
  const int plane = e / (n2 * n2);
  const int rem = e - plane * n2 * n2;
  const int i2 = rem / n2;
  const int j2 = rem - i2 * n2;
  const int ab = plane / 3;
  const int ch = plane - ab * 3;
  const int a = ab >> 1, b = ab & 1;
  const float* r = rects + ((long long)s * cs.n + c) * 4;
  const float sy = sample_at(i2 * p + a, size, r[1], r[3]);
  const float sx = sample_at(j2 * p + b, size, r[0], r[2]);
  OutT* dst = out + cs.offset[c] + (long long)s * cs.per_stream[c] + e;
  if (isnan(sy) || isnan(sx)) {
    *dst = cvt_out<OutT>(0.0f);
    return;
  }
  const int gy = (int)floorf(sy);
  const int gx = (int)floorf(sx);
  const float wy0 = tri(sy, gy, op_bf16), wy1 = tri(sy, gy + 1, op_bf16);
  const float wx0 = tri(sx, gx, op_bf16), wx1 = tri(sx, gx + 1, op_bf16);
  const uint8_t* f = frames + ((long long)s * 3 + ch) * h * w;
  float res = 0.0f;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int x = gx + q;
    if (x < 0 || x >= w) continue;
    // Row pass at frame column x: taps gy, gy + 1 (f32 sum, then rounded
    // to the operand type like the TPU kernel's `tmp`).
    float t = 0.0f;
    if (gy >= 0 && gy < h) t = __fmul_rn(wy0, (float)f[gy * w + x]);
    if (gy + 1 >= 0 && gy + 1 < h)
      t = __fadd_rn(t, __fmul_rn(wy1, (float)f[(gy + 1) * w + x]));
    t = round_op(t, op_bf16);
    res = __fadd_rn(res, __fmul_rn(t, q == 0 ? wx0 : wx1));
  }
  if (scale != 1.0f) res = __fmul_rn(res, scale);
  *dst = cvt_out<OutT>(res);
}

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// sizes/packs: host arrays of n crops; out: one buffer holding every crop's
// [S, 3*p*p, size/p, size/p] block back to back.
int multi_crop_launch(const void* frames, const void* rects, void* out,
                      const int* sizes, const int* packs, int n, int s,
                      int h, int w, float scale, int op_bf16, int out_bf16,
                      void* stream) {
  if (n < 1 || n > MAX_CROPS) return (int)cudaErrorInvalidValue;
  CropSet cs;
  cs.n = n;
  long long off = 0;
  int max_per = 0;
  for (int c = 0; c < n; ++c) {
    const int n2 = sizes[c] / packs[c];
    cs.size[c] = sizes[c];
    cs.pack[c] = packs[c];
    cs.per_stream[c] = 3 * packs[c] * packs[c] * n2 * n2;
    cs.offset[c] = off;
    off += (long long)s * cs.per_stream[c];
    if (cs.per_stream[c] > max_per) max_per = cs.per_stream[c];
  }
  const int threads = 256;
  dim3 grid((max_per + threads - 1) / threads, n, s);
  cudaStream_t st = (cudaStream_t)stream;
  if (out_bf16) {
    multi_crop_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        (const uint8_t*)frames, (const float*)rects, (__nv_bfloat16*)out,
        cs, h, w, scale, op_bf16);
  } else {
    multi_crop_kernel<float><<<grid, threads, 0, st>>>(
        (const uint8_t*)frames, (const float*)rects, (float*)out, cs, h, w,
        scale, op_bf16);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
