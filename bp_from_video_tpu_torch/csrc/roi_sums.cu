// K4: per-(stream, ROI) rectangular channel sums + denominator, and the
// ROI sample made from them, in one launch.
//
// Replaces: bp_from_video_tpu/pallas/roi_kernel.py `roi_sums`
// (pallas_call at :114, body `_kernel` at :39) and, in the sample entry,
// its caller's epilogue at bp_from_video_tpu/ops/roi.py:196-205 (finite
// mask, mean = sum / den, channel mix, NaN where invalid), which jax.jit
// fuses with the Pallas call into one program.
//
// Two C entries launch the same kernel template; they differ only in what
// a block's first thread writes at the end:
//   roi_sums_launch     sums f32 [S, R, 3] and denominators f32 [S, R];
//   roi_samples_launch  the sample f32 [S, R]: the green mean, or
//                       CHROM_GREEN g/2 - b/4 - r/4 + 0.5 of the three
//                       means, NaN unless the ROI row is finite and den > 0.
//
// What it computes: for integral ROIs (x, y, x0, y0, x1, y1) the sums of
// the three channel planes over frame[y0:y1, x0:x1] with Python slice
// semantics (a negative bound wraps by the axis length, then both clamp to
// [0, size]) and the denominator (the pixel count, or with a weight map
// [S, H, W] the weight sum, the sums then weighting each pixel).  A ROI row
// with any non-finite entry is an empty rect.  The weight map's rows are
// contiguous and its streams `wstride` floats apart, so a channel view of
// the segmenter's [S, 6, H, W] confidences is read in place.
//
// Numerics: unweighted sums accumulate in 32-bit integers (exact; a full
// 480x640 rect of 255s is 7.8e7 < 2^31) and round to f32 once; the
// denominator is the f32 product of the two counts, as in the plain
// version.  Below 2^24 (the forehead and palm ROIs) the sums equal the
// plain version's f32 sums, and the sample is bit-equal to it: an IEEE
// division (__fdiv_rn) and the mix in the plain composition's order with
// __fmul_rn / __fsub_rn / __fadd_rn, which nvcc cannot contract into an
// FMA.  Past 2^24 the integer sum is exact where the plain f32 einsum
// rounds its partial sums.  Weighted sums accumulate f32 products
// __fmul_rn(pixel, weight) with __fadd_rn in a fixed order (deterministic),
// another order than the plain version's two dots.
//
// Bound on this card: bytes, the u8 planes the output needs (the green
// plane alone for a GREEN sample, all three for CHROM_GREEN and the sums;
// the kernel reads no other) plus a f32 weight per ROI pixel, read once.  In practice launch and round-trip latency: at the
// flagship a ROI is about 56x42 or 40x40 pixels, 5-7 KB of the three
// planes, and 128 ROIs give one block an SM.  Warps walking the rect's
// rows with one byte a lane per plane would wait about 11 load round trips
// in series; this design gets all loads of a ROI in flight at once:
// - one block of 256 threads per (stream, ROI);
// - the rect is flattened into items (row, word); a word is 4 bytes of a
//   plane row (the word route: w % 4 == 0 and 4-byte aligned frames, and
//   16-byte aligned weights when weighted) or one byte (the byte route,
//   any width and alignment; the wrapper picks the route);
// - a thread takes items t, t + 256, t + 512, t + 768 together and issues
//   all their loads (its planes, and a weight vector) before any add;
//   the item index is clamped and its mask zeroed past the end, so every
//   load is unconditional.  At the flagship sizes (at most 630 words a
//   plane) each thread waits one round trip;
// - the edge bytes of a word outside [x0, x1) are masked off, and bytes
//   are summed with __dp4a(word & mask, 0x01010101, acc);
// - warp shuffles, then warp 0 over the 8 warp partials, then thread 0
//   writes the sums or the sample.
// One block per ROI, rather than a ROI's rows split over several blocks:
// at the flagship a block makes one round trip for its pixels, so what is
// left is the launch and the load of the ROI row, which more blocks would
// not shorten (about 0.004 ms a launch at the flagship ROI sizes on an
// H100 SXM at 700 W, chip_smoke.py phase 2), and a cross-block finish would
// need scratch memory or atomics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 256
#define NWARPS (THREADS / 32)
#define ITEMS 4  // items a thread loads before its first add

enum { OUT_SUMS = 0, OUT_GREEN = 1, OUT_CHROM_GREEN = 2 };

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

template <int VEC>
__device__ __forceinline__ unsigned int load_word(const uint8_t* p) {
  if (VEC == 4) return *reinterpret_cast<const unsigned int*>(p);
  return *p;
}

template <int VEC>
__device__ __forceinline__ void load_weights(const float* p, float* out) {
  if (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
    out[0] = *p;
  }
}

// GREEN_ONLY: the green plane alone is read and summed (the GREEN sample);
// otherwise all three.
template <int VEC, bool WEIGHTED, bool GREEN_ONLY>
__global__ void __launch_bounds__(THREADS)
    roi_kernel(const uint8_t* __restrict__ frames,
               const float* __restrict__ rois,
               const float* __restrict__ weights, long long wstride,
               float* __restrict__ out0, float* __restrict__ out1, int nroi,
               int h, int w, int mode) {
  const long long idx = (long long)blockIdx.y * nroi + blockIdx.x;
  bool finite = true;
  float v[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    v[i] = rois[idx * 6 + i];
    finite = finite && isfinite(v[i]);
  }
  int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  if (finite) {
    x0 = span_bound(v[2], w);
    y0 = span_bound(v[3], h);
    x1 = span_bound(v[4], w);
    y1 = span_bound(v[5], h);
  }
  const int ny = y1 > y0 ? y1 - y0 : 0, nx = x1 > x0 ? x1 - x0 : 0;
  // Words of a row that meet [x0, x1): wa .. wa + nw - 1.
  const int wa = x0 / VEC;
  const int nw = nx > 0 ? (x1 - 1) / VEC - wa + 1 : 0;
  const int n = ny * nw;
  constexpr int C0 = GREEN_ONLY ? 1 : 0, C1 = GREEN_ONLY ? 2 : 3;

  const long long plane = (long long)h * w;
  const uint8_t* f = frames + blockIdx.y * 3 * plane;
  const float* wm = WEIGHTED ? weights + blockIdx.y * wstride : nullptr;
  unsigned int isum[3] = {0u, 0u, 0u};
  float fsum[4] = {0.f, 0.f, 0.f, 0.f};
  for (int base = threadIdx.x; base < n; base += THREADS * ITEMS) {
    unsigned int px[ITEMS][3], mask[ITEMS];
    float wt[ITEMS][VEC];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = base + k * THREADS;
      const int ic = i < n ? i : n - 1;
      const int row = ic / nw;
      const int c = (wa + ic - row * nw) * VEC;  // the word's first column
      const int lo = x0 - c > 0 ? x0 - c : 0;
      const int hi = x1 - c < VEC ? x1 - c : VEC;
      const unsigned long long m =
          ((1ull << (8 * hi)) - 1) & ~((1ull << (8 * lo)) - 1);
      mask[k] = i < n ? (unsigned int)m : 0u;
      const long long o = (long long)(y0 + row) * w + c;
#pragma unroll
      for (int ch = C0; ch < C1; ++ch)
        px[k][ch] = load_word<VEC>(f + ch * plane + o);
      if (WEIGHTED) load_weights<VEC>(wm + o, wt[k]);
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (!WEIGHTED) {
#pragma unroll
        for (int ch = C0; ch < C1; ++ch)
          isum[ch] = __dp4a(px[k][ch] & mask[k], 0x01010101u, isum[ch]);
      } else {
#pragma unroll
        for (int b = 0; b < VEC; ++b) {
          const float wb = (mask[k] >> (8 * b)) & 1u ? wt[k][b] : 0.0f;
#pragma unroll
          for (int ch = C0; ch < C1; ++ch) {
            const float p = (float)((px[k][ch] >> (8 * b)) & 0xffu);
            fsum[ch] = __fadd_rn(fsum[ch], __fmul_rn(p, wb));
          }
          fsum[3] = __fadd_rn(fsum[3], wb);
        }
      }
    }
  }

  // Block reduction in a fixed order: lanes, then warps.
  __shared__ unsigned int red_u[3][NWARPS];
  __shared__ float red_f[4][NWARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (WEIGHTED) {
#pragma unroll
    for (int c = C0; c < C1; ++c) {
      fsum[c] = warp_sum(fsum[c]);
      if (lane == 0) red_f[c][warp] = fsum[c];
    }
    fsum[3] = warp_sum(fsum[3]);
    if (lane == 0) red_f[3][warp] = fsum[3];
  } else {
#pragma unroll
    for (int c = C0; c < C1; ++c) {
      isum[c] = warp_sum(isum[c]);
      if (lane == 0) red_u[c][warp] = isum[c];
    }
  }
  __syncthreads();
  if (warp != 0) return;
  float sum[3] = {0.f, 0.f, 0.f}, den;
  if (!WEIGHTED) {
#pragma unroll
    for (int c = C0; c < C1; ++c)
      sum[c] = (float)warp_sum(lane < NWARPS ? red_u[c][lane] : 0u);
    den = __fmul_rn((float)ny, (float)nx);
  } else {
#pragma unroll
    for (int c = C0; c < C1; ++c)
      sum[c] = warp_sum(lane < NWARPS ? red_f[c][lane] : 0.0f);
    den = warp_sum(lane < NWARPS ? red_f[3][lane] : 0.0f);
  }
  if (lane != 0) return;
  if (mode == OUT_SUMS) {
    out0[idx * 3] = sum[0];
    out0[idx * 3 + 1] = sum[1];
    out0[idx * 3 + 2] = sum[2];
    out1[idx] = den;
    return;
  }
  const float d = den > 0.0f ? den : 1.0f;
  float val = __fdiv_rn(sum[1], d);
  if (mode == OUT_CHROM_GREEN) {
    const float r = __fdiv_rn(sum[0], d), b = __fdiv_rn(sum[2], d);
    val = __fadd_rn(__fsub_rn(__fsub_rn(__fmul_rn(val, 0.5f),
                                        __fmul_rn(b, 0.25f)),
                              __fmul_rn(r, 0.25f)),
                    0.5f);
  }
  out0[idx] = finite && den > 0.0f ? val : __int_as_float(0x7fc00000);
}

template <int VEC, bool WEIGHTED>
static int launch(const void* frames, const void* rois, const void* weights,
                  long long wstride, void* out0, void* out1, int s, int nroi,
                  int h, int w, int mode, void* stream) {
  dim3 grid(nroi, s);
  auto kernel = mode == OUT_GREEN ? roi_kernel<VEC, WEIGHTED, true>
                                  : roi_kernel<VEC, WEIGHTED, false>;
  kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (const float*)rois, (const float*)weights,
      wstride, (float*)out0, (float*)out1, nroi, h, w, mode);
  return (int)cudaGetLastError();
}

static int dispatch(const void* frames, const void* rois, const void* weights,
                    long long wstride, void* out0, void* out1, int s,
                    int nroi, int h, int w, int vec, int mode, void* stream) {
  if (weights != nullptr && wstride < (long long)h * w)
    return (int)cudaErrorInvalidValue;
  if (vec == 4) {
    // The word route reads 4-byte words of the frames and 16-byte vectors
    // of the weights, every stream's included: refuse what is not aligned
    // for them.
    if (w % 4 != 0 || (uintptr_t)frames % 4 != 0 ||
        (weights != nullptr &&
         ((uintptr_t)weights % 16 != 0 || wstride % 4 != 0)))
      return (int)cudaErrorInvalidValue;
    return weights ? launch<4, true>(frames, rois, weights, wstride, out0,
                                     out1, s, nroi, h, w, mode, stream)
                   : launch<4, false>(frames, rois, weights, wstride, out0,
                                      out1, s, nroi, h, w, mode, stream);
  }
  if (vec != 1) return (int)cudaErrorInvalidValue;
  return weights ? launch<1, true>(frames, rois, weights, wstride, out0, out1,
                                   s, nroi, h, w, mode, stream)
                 : launch<1, false>(frames, rois, weights, wstride, out0,
                                    out1, s, nroi, h, w, mode, stream);
}

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// frames u8 [S, 3, H, W]; rois f32 [S, R, 6]; weights f32 [S, H, W] with
// contiguous rows and streams wstride >= H * W floats apart, or null; sums
// f32 [S, R, 3]; denoms f32 [S, R].  vec: 4 (word route) or 1 (byte
// route).
int roi_sums_launch(const void* frames, const void* rois, const void* weights,
                    long long wstride, void* sums, void* denoms, int s,
                    int nroi, int h, int w, int vec, void* stream) {
  return dispatch(frames, rois, weights, wstride, sums, denoms, s, nroi, h, w,
                  vec, OUT_SUMS, stream);
}

// As roi_sums_launch, writing samples f32 [S, R]; channel 1 = GREEN,
// 2 = CHROM_GREEN.
int roi_samples_launch(const void* frames, const void* rois,
                       const void* weights, long long wstride, void* samples,
                       int s, int nroi, int h, int w, int vec, int channel,
                       void* stream) {
  if (channel != OUT_GREEN && channel != OUT_CHROM_GREEN)
    return (int)cudaErrorInvalidValue;
  return dispatch(frames, rois, weights, wstride, samples, nullptr, s, nroi,
                  h, w, vec, channel, stream);
}

}  // extern "C"
