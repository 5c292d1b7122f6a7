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
// written once.  What costs time is instructions per element and the L1
// wavefronts of the byte gathers, so:
//  - A sample coordinate depends on the output row or the output column
//    alone.  A block = one (stream, crop, band of crop rows); before any
//    output it builds in shared memory one tap entry per crop column and
//    per row of its band, with `sample_at` and `tri`, reading the rect
//    once.  An entry is the frame pair (g, g+1) holding the two taps and a
//    weight for each; at the frame's edge it is the edge pair, the tap off
//    the frame weighted 0.  Every product is then >= +0 and every sum of
//    such terms is exact when a term is +0, so the result is bit-equal to
//    skipping the tap (a NaN sample zeroes both weights: the zero crop).
//    The second tap of a pair is the first's address + 1 (an immediate),
//    and the next row's + w.
//  - A thread computes RUN = 2 neighbouring outputs of one packed row, for
//    each of the p column parities and the 3 channels, which share its row
//    entry and its column entries: 6 (pack 1) or 12 (pack 2) outputs, no
//    division per element; it takes UNITS = 4 such runs, so that a block's
//    tables serve 4 x 128 runs.  Longer runs (8 outputs, a 16-byte bf16
//    store) were slower on the card: a warp's lanes then gather bytes from
//    a frame span 4 times wider, in more L1 wavefronts per load.  With runs
//    of 2 a warp's stores still cover 128 contiguous bytes (bf16).
//  - A frame byte becomes a float by its bits (2^23 + byte, minus 2^23), two
//    ALU instructions in place of the slower integer conversion; the two
//    row-pass values of an output are rounded to bf16 in one paired
//    conversion.
//  - Outputs go out as one 4-byte (bf16) or 8-byte (f32) store per run
//    where the packed side is even and the crop's block is aligned, else
//    scalar stores with a ragged tail.
// All crops of all streams are ONE launch: grid.x walks every crop's bands
// back to back, grid.y is the stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MAX_CROPS 8
#define THREADS 128
#define RUN 2       // outputs of one packed row per thread
#define UNITS 4     // runs per thread

struct CropSet {
  int n;
  int size[MAX_CROPS];
  int pack[MAX_CROPS];
  int runs[MAX_CROPS];              // ceil((size/p) / RUN) runs a row
  int rows[MAX_CROPS];              // crop rows per block
  int first_band[MAX_CROPS + 1];    // grid.x of crop c's first block
  int vec[MAX_CROPS];               // one store per run
  int per_stream[MAX_CROPS];        // 3 * p*p * (size/p)^2
  long long offset[MAX_CROPS];      // element offset of crop c's block
};

// The two taps of one output row or column, as the frame pair (i, i + 1)
// that holds them (i already times the frame width for a row) and the
// weight of each; a tap off the frame has weight 0.
struct __align__(16) Tap {
  int i;
  float w0, w1;
  int pad;
};

__device__ __forceinline__ float round_op(float v, bool bf16) {
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

__device__ __forceinline__ float tri(float s, int g, bool bf16) {
  float d = fabsf(__fsub_rn(s, (float)g));
  return round_op(fmaxf(0.0f, __fsub_rn(1.0f, d)), bf16);
}

// The taps of crop pixel `idx` on a frame axis of `len` >= 2 pixels.  The
// pair is the taps' own (g, g + 1) where both lie on the frame, else the
// edge pair holding the one that does, with 0 for the other.
__device__ __forceinline__ Tap make_tap(int idx, int size, float center,
                                        float extent, int len, int stride,
                                        bool bf16) {
  Tap t = {0, 0.0f, 0.0f, 0};
  const float s = sample_at(idx, size, center, extent);
  if (isnan(s)) return t;
  const int g = (int)floorf(s);
  if (g >= 0 && g < len - 1) {
    t.i = g * stride;
    t.w0 = tri(s, g, bf16);
    t.w1 = tri(s, g + 1, bf16);
  } else if (g == -1) {
    t.w0 = tri(s, 0, bf16);
  } else if (g == len - 1) {
    t.i = (len - 2) * stride;
    t.w1 = tri(s, g, bf16);
  }
  return t;
}

// A frame byte as f32, exactly: the bits of 2^23 + v, minus 2^23.
__device__ __forceinline__ float u8f(const uint8_t* p) {
  return __fsub_rn(__uint_as_float(0x4b000000u | (uint32_t)*p), 8388608.0f);
}

// Two values rounded to the operand type (one paired conversion for bf16).
template <bool BF16>
__device__ __forceinline__ void round_op2(float& a, float& b) {
  if constexpr (BF16) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
    a = __uint_as_float(u << 16);
    b = __uint_as_float(u & 0xffff0000u);
  }
}

// A run's RUN = 2 outputs to an address aligned to their size.
__device__ __forceinline__ void st_run(float* p, const float* v) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void st_run(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}

__device__ __forceinline__ void st1(float* p, float v) { *p = v; }
__device__ __forceinline__ void st1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename OutT, bool OP_BF16>
__global__ void __launch_bounds__(THREADS)
multi_crop_kernel(const uint8_t* __restrict__ frames,
                  const float* __restrict__ rects, OutT* __restrict__ out,
                  CropSet cs, int h, int w, float scale) {
  // Column taps [size], then the band's row taps [rows].
  extern __shared__ Tap taps[];
  __shared__ float rect[4];
  int c = 0;
  while (c + 1 < cs.n && (int)blockIdx.x >= cs.first_band[c + 1]) ++c;
  const int s = blockIdx.y;
  const int size = cs.size[c], p = cs.pack[c], runs = cs.runs[c];
  const int n2 = size / p;
  const int r0 = ((int)blockIdx.x - cs.first_band[c]) * cs.rows[c];
  const int nrows = min(cs.rows[c], size - r0);
  if (threadIdx.x < 4)
    rect[threadIdx.x] = rects[((long long)s * cs.n + c) * 4 + threadIdx.x];
  __syncthreads();
  Tap* cols = taps;
  Tap* rows = taps + size;
  for (int q = threadIdx.x; q < size; q += THREADS)
    cols[q] = make_tap(q, size, rect[0], rect[2], w, 1, OP_BF16);
  for (int q = threadIdx.x; q < nrows; q += THREADS)
    rows[q] = make_tap(r0 + q, size, rect[1], rect[3], h, w, OP_BF16);
  __syncthreads();

  const int hw = h * w;
  const uint8_t* fs = frames + (long long)s * 3 * hw;
  const long long plane = (long long)n2 * n2;
  OutT* os = out + cs.offset[c] + (long long)s * cs.per_stream[c];
  for (int u = threadIdx.x; u < nrows * runs; u += THREADS) {
    const int rr = u / runs;               // once per thread and run
    const int j0 = (u - rr * runs) * RUN;
    const int r = r0 + rr;                 // crop row = i * p + a
    const int a = p == 2 ? r & 1 : 0;
    const int i = p == 2 ? r >> 1 : r;
    const Tap ty = rows[rr];
    for (int b = 0; b < p; ++b) {
      Tap tx[RUN];
      const uint8_t* f[RUN];               // frame (row pair, column pair)
#pragma unroll
      for (int k = 0; k < RUN; ++k) {
        tx[k] = j0 + k < n2 ? cols[(j0 + k) * p + b] : Tap{0, 0.0f, 0.0f, 0};
        f[k] = fs + ty.i + tx[k].i;
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float v[RUN];
#pragma unroll
        for (int k = 0; k < RUN; ++k) {
          // Row pass at the two frame columns (f32 sum, rounded to the
          // operand type like the TPU kernel's `tmp`), then the column
          // pass, `* scale`.  Every term is >= +0, so a tap of weight 0
          // adds an exact +0: the TPU kernel's sums bit for bit.
          const uint8_t* q = f[k] + ch * hw;
          float t0 = __fadd_rn(__fmul_rn(ty.w0, u8f(q)),
                               __fmul_rn(ty.w1, u8f(q + w)));
          float t1 = __fadd_rn(__fmul_rn(ty.w0, u8f(q + 1)),
                               __fmul_rn(ty.w1, u8f(q + w + 1)));
          round_op2<OP_BF16>(t0, t1);
          v[k] = __fmul_rn(__fadd_rn(__fmul_rn(t0, tx[k].w0),
                                     __fmul_rn(t1, tx[k].w1)),
                           scale);
        }
        OutT* o = os + ((a * p + b) * 3 + ch) * plane + (long long)i * n2 + j0;
        if (cs.vec[c]) {
          st_run(o, v);
        } else {
#pragma unroll
          for (int k = 0; k < RUN; ++k)
            if (j0 + k < n2) st1(o + k, v[k]);
        }
      }
    }
  }
}

template <typename OutT, bool OP_BF16>
static void launch(dim3 grid, size_t smem, cudaStream_t st,
                   const uint8_t* frames, const float* rects, void* out,
                   const CropSet& cs, int h, int w, float scale) {
  multi_crop_kernel<OutT, OP_BF16><<<grid, THREADS, smem, st>>>(
      frames, rects, (OutT*)out, cs, h, w, scale);
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
  if (n < 1 || n > MAX_CROPS || h < 2 || w < 2)
    return (int)cudaErrorInvalidValue;
  CropSet cs;
  cs.n = n;
  long long off = 0;
  int max_size = 0, max_rows = 0;
  const int esize = out_bf16 ? 2 : 4;
  cs.first_band[0] = 0;
  for (int c = 0; c < n; ++c) {
    const int n2 = sizes[c] / packs[c];
    cs.size[c] = sizes[c];
    cs.pack[c] = packs[c];
    cs.runs[c] = (n2 + RUN - 1) / RUN;
    cs.rows[c] = cs.runs[c] >= UNITS * THREADS
                     ? 1 : UNITS * THREADS / cs.runs[c];
    cs.first_band[c + 1] =
        cs.first_band[c] + (sizes[c] + cs.rows[c] - 1) / cs.rows[c];
    cs.per_stream[c] = 3 * packs[c] * packs[c] * n2 * n2;
    cs.offset[c] = off;
    cs.vec[c] = n2 % RUN == 0 &&
                ((uintptr_t)out + (uintptr_t)off * esize) % (RUN * esize) == 0;
    off += (long long)s * cs.per_stream[c];
    if (sizes[c] > max_size) max_size = sizes[c];
    if (cs.rows[c] > max_rows) max_rows = cs.rows[c];
  }
  dim3 grid(cs.first_band[n], s);
  const size_t smem = (size_t)(max_size + max_rows) * sizeof(Tap);
  cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* f = (const uint8_t*)frames;
  const float* r = (const float*)rects;
  if (out_bf16 && op_bf16)
    launch<__nv_bfloat16, true>(grid, smem, st, f, r, out, cs, h, w, scale);
  else if (out_bf16)
    launch<__nv_bfloat16, false>(grid, smem, st, f, r, out, cs, h, w, scale);
  else if (op_bf16)
    launch<float, true>(grid, smem, st, f, r, out, cs, h, w, scale);
  else
    launch<float, false>(grid, smem, st, f, r, out, cs, h, w, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
