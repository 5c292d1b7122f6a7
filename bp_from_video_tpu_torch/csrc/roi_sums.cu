// K4: per-(stream, ROI) rectangular channel sums + denominator.
//
// Replaces: bp_from_video_tpu/pallas/roi_kernel.py `roi_sums`
// (pallas_call at :114, body `_kernel` at :39).
//
// What it computes: for integral ROIs (x, y, x0, y0, x1, y1) the sums of
// the three channel planes over frame[y0:y1, x0:x1] with Python slice
// semantics (a negative bound wraps by the axis length, then both clamp to
// [0, size]) and the denominator (the pixel count, or with a weight map
// [S, H, W] the weight sum, the sums then weighting each pixel).
//
// Numerics: unweighted sums accumulate in 32-bit integers (exact; a full
// 480x640 rect of 255s is 7.8e7 < 2^32) and round to f32 once.  The TPU
// kernel sums in f32 (exact only below 2^24), so a rect whose sum passes
// 2^24 may differ from it by f32 rounding of its partial sums; below 2^24
// (the forehead/palm ROIs) both are exact and bit-equal.  Weighted sums
// accumulate f32 products pixel * weight (rounded like the TPU's
// `f * wmap`), in another order than the TPU's two dots.
//
// Bound on this card: bytes — three u8 planes (plus a f32 weight) per ROI
// pixel, read once; the work is a handful of integer adds per byte.
// Design: one block per (stream, ROI); each warp walks frame rows of the
// rect with lanes on consecutive columns (coalesced), then a warp-shuffle +
// shared-memory reduction.  Blocks of empty rects exit after writing zeros.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

__device__ __forceinline__ int span_bound(float v, int size) {
  float u = v < 0.0f ? v + (float)size : v;
  u = fminf(fmaxf(u, 0.0f), (float)size);
  return (int)u;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void roi_sums_kernel(const uint8_t* __restrict__ frames,
                                const float* __restrict__ rois,
                                const float* __restrict__ weights,
                                float* __restrict__ sums,
                                float* __restrict__ denoms, int nroi, int h,
                                int w) {
  const int r = blockIdx.x;
  const int s = blockIdx.y;
  const float* roi = rois + ((long long)s * nroi + r) * 6;
  const int x0 = span_bound(roi[2], w), y0 = span_bound(roi[3], h);
  const int x1 = span_bound(roi[4], w), y1 = span_bound(roi[5], h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = THREADS / 32;
  const long long plane = (long long)h * w;
  const uint8_t* f = frames + (long long)s * 3 * plane;
  __shared__ float red_f[4][THREADS / 32];
  __shared__ unsigned int red_u[3][THREADS / 32];
  float out[4];
  if (weights == nullptr) {
    unsigned int acc[3] = {0u, 0u, 0u};
    for (int y = y0 + warp; y < y1; y += nwarps)
      for (int x = x0 + lane; x < x1; x += 32) {
        const long long o = (long long)y * w + x;
        acc[0] += f[o];
        acc[1] += f[plane + o];
        acc[2] += f[2 * plane + o];
      }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      acc[c] = warp_sum(acc[c]);
      if (lane == 0) red_u[c][warp] = acc[c];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int c = 0; c < 3; ++c) {
        unsigned int t = 0u;
        for (int i = 0; i < nwarps; ++i) t += red_u[c][i];
        out[c] = (float)t;
      }
      const float ny = (float)(y1 > y0 ? y1 - y0 : 0);
      const float nx = (float)(x1 > x0 ? x1 - x0 : 0);
      out[3] = ny * nx;
    }
  } else {
    const float* wm = weights + (long long)s * plane;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int y = y0 + warp; y < y1; y += nwarps)
      for (int x = x0 + lane; x < x1; x += 32) {
        const long long o = (long long)y * w + x;
        const float wt = wm[o];
        acc[0] = __fadd_rn(acc[0], __fmul_rn((float)f[o], wt));
        acc[1] = __fadd_rn(acc[1], __fmul_rn((float)f[plane + o], wt));
        acc[2] = __fadd_rn(acc[2], __fmul_rn((float)f[2 * plane + o], wt));
        acc[3] = __fadd_rn(acc[3], wt);
      }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc[c] = warp_sum(acc[c]);
      if (lane == 0) red_f[c][warp] = acc[c];
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int c = 0; c < 4; ++c) {
        float t = 0.f;
        for (int i = 0; i < nwarps; ++i) t += red_f[c][i];
        out[c] = t;
      }
  }
  if (threadIdx.x == 0) {
    float* so = sums + ((long long)s * nroi + r) * 3;
    so[0] = out[0];
    so[1] = out[1];
    so[2] = out[2];
    denoms[(long long)s * nroi + r] = out[3];
  }
}

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// frames u8 [S, 3, H, W]; rois f32 [S, R, 6] (finite); weights f32
// [S, H, W] or null; sums f32 [S, R, 3]; denoms f32 [S, R].
int roi_sums_launch(const void* frames, const void* rois, const void* weights,
                    void* sums, void* denoms, int s, int nroi, int h, int w,
                    void* stream) {
  dim3 grid(nroi, s);
  roi_sums_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)rois, (const float*)weights,
      (float*)sums, (float*)denoms, nroi, h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
