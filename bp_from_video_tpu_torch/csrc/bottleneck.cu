// K5 and K6: the face-mesh bottleneck residual unit, alone (K5) or as a
// chain of U same-shape units in one launch (K6).
//
// Replaces: bp_from_video_tpu/pallas/block_kernel.py `bottleneck_s1`
// (pallas_call in `_bottleneck_call` at :350, body `_bottleneck_kernel` at
// :246) and `bottleneck_chain` (pallas_call in `_bottleneck_chain_call` at
// :461, body `_bottleneck_chain_kernel` at :407).
//
// What one unit computes, per crop:
//   z   = PReLU_ad(Wd[D, C] . x + bd)          f32 accumulation, then rounded
//                                              to the weight type
//   acc = Wu[C', 9D] . win9(z) + bu + r        win9 = the nine unit shifts of
//                                              z, SAME zero padding OF z
//   y   = act(acc) rounded once to the output type (act: none/relu/prelu)
// K5 takes the residual r as a second input (C' may differ from C); in K6
// every unit's residual is its own input and its output feeds the next unit.
//
// Bound on this card: bytes (a chain reads x once and writes y once: about
// 40 flops per byte per unit at C = 16, D = 8, far under the ~295 at which
// bf16 tensor cores would become the limit).  What the design does about
// it: the image is tiled, and a block keeps its tile of the activation in
// shared memory through all U units, so a chain moves each activation byte
// once whatever U is.  A crop does not fit in shared memory, so a block
// loads its output tile plus a halo of U pixels and recomputes the halo:
// unit u computes z on the tile + (U-u) pixels and y on the tile + (U-u-1).
// Pixels outside the image are forced to z = 0 in every unit (the padding is
// of z, not of x); y outside the image is never read.  Weights are
// converted once per launch into a f32 scratch laid out channel-minor
// (a prep kernel in the same C entry), so a thread reads four channels'
// weights with one 16-byte load.  The arithmetic is plain f32 FMA (products
// of bf16 values are exact in f32); tensor cores are left for a later
// version.  Activations and z sit in shared memory as f32 holding values
// already rounded to their type.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define THREADS 256
#define CG 16   // output channels per work item in the second product
#define DG 8    // mid channels per work item in the first product
#define MAX_SMEM 232448

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

// A f32 value rounded to T and back.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// wd [U, D, C] -> wdT [U, C, DP]; wu [U, CO, 9D] -> wuT [U, 9D, CP]; f32,
// zero in the padded channels.
template <typename W>
__global__ void bottleneck_prep_kernel(const W* __restrict__ wd,
                                       const W* __restrict__ wu,
                                       float* __restrict__ wdT,
                                       float* __restrict__ wuT, int U, int C,
                                       int D, int CO, int DP, int CP) {
  const int n_d = U * C * DP;
  const int n_u = U * 9 * D * CP;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_d + n_u;
       i += gridDim.x * blockDim.x) {
    if (i < n_d) {
      const int d = i % DP, c = (i / DP) % C, u = i / (DP * C);
      wdT[i] = d < D ? ld<W>(wd + ((long long)u * D + d) * C + c) : 0.0f;
    } else {
      const int j = i - n_d;
      const int co = j % CP, k = (j / CP) % (9 * D), u = j / (CP * 9 * D);
      wuT[j] = co < CO ? ld<W>(wu + ((long long)u * CO + co) * 9 * D + k)
                       : 0.0f;
    }
  }
}

// One block: one (crop, tile).  Shared memory: ys [C][NP] then zs [D][NP],
// NP = RH * RW, the tile plus a halo of U pixels on every side.
template <typename T>
__global__ void __launch_bounds__(THREADS)
bottleneck_kernel(const T* __restrict__ x, const T* __restrict__ r,
                  const float* __restrict__ wdT, const float* __restrict__ bd,
                  const float* __restrict__ ad, const float* __restrict__ wuT,
                  const float* __restrict__ bu, const float* __restrict__ au,
                  T* __restrict__ out, int U, int C, int D, int CO, int DP,
                  int CP, int H, int Wd, int TH, int TW, int tiles_x, int act,
                  int z_bf16) {
  extern __shared__ __align__(16) float smem[];
  const int RH = TH + 2 * U, RW = TW + 2 * U, NP = RH * RW;
  float* ys = smem;
  float* zs = smem + (size_t)C * NP;
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_x) * TH - U;   // image row of region row 0
  const int x0 = (blockIdx.x % tiles_x) * TW - U;
  const int tid = threadIdx.x;
  const long long hw = (long long)H * Wd;
  const T* xb = x + (long long)b * C * hw;

  for (int e = tid; e < C * NP; e += THREADS) {
    const int c = e / NP, q = e - c * NP;
    const int iy = y0 + q / RW, ix = x0 + q % RW;
    float v = 0.0f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < Wd)
      v = ld<T>(xb + c * hw + (long long)iy * Wd + ix);
    ys[e] = v;
  }
  __syncthreads();

  for (int u = 0; u < U; ++u) {
    // -- z on the region shrunk by u ------------------------------------------
    {
      const int zh = RH - 2 * u, zw = RW - 2 * u, nz = zh * zw;
      const float* wdu = wdT + (long long)u * C * DP;
      for (int it = tid; it < nz * (DP / DG); it += THREADS) {
        const int g = it / nz, p = it - g * nz;
        const int ry = u + p / zw, rx = u + p % zw;
        const int q = ry * RW + rx;
        const int iy = y0 + ry, ix = x0 + rx;
        float acc[DG];
#pragma unroll
        for (int j = 0; j < DG; ++j) acc[j] = 0.0f;
        const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < Wd;
        if (inside) {
          for (int c = 0; c < C; ++c) {
            const float xv = ys[c * NP + q];
            const float4* wp =
                reinterpret_cast<const float4*>(wdu + c * DP + g * DG);
            const float4 w0 = __ldg(wp), w1 = __ldg(wp + 1);
            acc[0] += w0.x * xv; acc[1] += w0.y * xv;
            acc[2] += w0.z * xv; acc[3] += w0.w * xv;
            acc[4] += w1.x * xv; acc[5] += w1.y * xv;
            acc[6] += w1.z * xv; acc[7] += w1.w * xv;
          }
        }
#pragma unroll
        for (int j = 0; j < DG; ++j) {
          const int d = g * DG + j;
          if (d >= D) continue;
          float v = 0.0f;                 // SAME padding of z: zero outside
          if (inside) {
            v = acc[j] + bd[u * D + d];
            v = v >= 0.0f ? v : v * ad[u * D + d];
            if (z_bf16) v = round_to<__nv_bfloat16>(v);
          }
          zs[d * NP + q] = v;
        }
      }
    }
    __syncthreads();
    // -- y on the region shrunk by u + 1 --------------------------------------
    {
      const int m = u + 1;
      const int yh = RH - 2 * m, yw = RW - 2 * m, ny = yh * yw;
      const float* wuu = wuT + (long long)u * 9 * D * CP;
      const bool last = u == U - 1;
      for (int it = tid; it < ny * (CP / CG); it += THREADS) {
        const int g = it / ny, p = it - g * ny;
        const int ry = m + p / yw, rx = m + p % yw;
        const int q = ry * RW + rx;
        const int iy = y0 + ry, ix = x0 + rx;
        if (iy < 0 || iy >= H || ix < 0 || ix >= Wd) continue;
        float acc[CG];
#pragma unroll
        for (int j = 0; j < CG; ++j) acc[j] = 0.0f;
        for (int t = 0; t < 9; ++t) {
          const int q2 = q + (t / 3 - 1) * RW + (t % 3 - 1);
          const float* wt = wuu + (long long)t * D * CP + g * CG;
          for (int d = 0; d < D; ++d) {
            const float zv = zs[d * NP + q2];
            const float4* wp = reinterpret_cast<const float4*>(wt + d * CP);
#pragma unroll
            for (int v4 = 0; v4 < CG / 4; ++v4) {
              const float4 w = __ldg(wp + v4);
              acc[4 * v4 + 0] += w.x * zv;
              acc[4 * v4 + 1] += w.y * zv;
              acc[4 * v4 + 2] += w.z * zv;
              acc[4 * v4 + 3] += w.w * zv;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < CG; ++j) {
          const int co = g * CG + j;
          if (co >= CO) continue;
          float v = acc[j] + bu[u * CO + co];
          const long long gi = ((long long)b * CO + co) * hw +
                               (long long)iy * Wd + ix;
          v += r != nullptr ? ld<T>(r + gi) : ys[co * NP + q];
          if (act == 2) {
            v = v >= 0.0f ? v : v * au[u * CO + co];
          } else if (act == 1) {
            v = fmaxf(v, 0.0f);
          }
          if (last) {
            out[gi] = st_cvt<T>(v);
          } else {
            ys[co * NP + q] = round_to<T>(v);   // one rounding per unit
          }
        }
      }
    }
    __syncthreads();
  }
}

static int pick_tile(int U, int C, int D, int H, int Wd, int* th, int* tw) {
  const int cands[4] = {16, 8, 4, 2};
  for (int i = 0; i < 4; ++i) {
    const int a = cands[i] < H ? cands[i] : H;
    const int b = cands[i] < Wd ? cands[i] : Wd;
    const long long bytes =
        (long long)(C + D) * (a + 2 * U) * (b + 2 * U) * sizeof(float);
    if (bytes <= MAX_SMEM) {
      *th = a;
      *tw = b;
      return (int)bytes;
    }
  }
  return -1;
}

template <typename T>
static int launch(const void* x, const void* r, const void* wd, const void* bd,
                  const void* ad, const void* wu, const void* bu,
                  const void* au, void* scratch, void* out, int B, int U,
                  int C, int D, int CO, int H, int Wd, int act, int w_bf16,
                  cudaStream_t st) {
  const int DP = (D + DG - 1) / DG * DG, CP = (CO + CG - 1) / CG * CG;
  float* wdT = (float*)scratch;
  float* wuT = wdT + (size_t)U * C * DP;
  const int n = U * C * DP + U * 9 * D * CP;
  const int pb = (n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024;
  if (w_bf16) {
    bottleneck_prep_kernel<__nv_bfloat16><<<pb, 256, 0, st>>>(
        (const __nv_bfloat16*)wd, (const __nv_bfloat16*)wu, wdT, wuT, U, C, D,
        CO, DP, CP);
  } else {
    bottleneck_prep_kernel<float><<<pb, 256, 0, st>>>(
        (const float*)wd, (const float*)wu, wdT, wuT, U, C, D, CO, DP, CP);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int th = 0, tw = 0;
  const int bytes = pick_tile(U, C, D, H, Wd, &th, &tw);
  if (bytes < 0) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(bottleneck_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_SMEM);
  if (e != cudaSuccess) return (int)e;
  const int tiles_x = (Wd + tw - 1) / tw, tiles_y = (H + th - 1) / th;
  dim3 grid(tiles_x * tiles_y, B);
  bottleneck_kernel<T><<<grid, THREADS, bytes, st>>>(
      (const T*)x, (const T*)r, wdT, (const float*)bd, (const float*)ad, wuT,
      (const float*)bu, (const float*)au, (T*)out, U, C, D, CO, DP, CP, H, Wd,
      th, tw, tiles_x, act, w_bf16);
  return (int)cudaGetLastError();
}

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// Floats of scratch a launch needs for its converted weights.
int bottleneck_scratch_floats(int U, int C, int D, int CO) {
  const int DP = (D + DG - 1) / DG * DG, CP = (CO + CG - 1) / CG * CG;
  return U * C * DP + U * 9 * D * CP;
}

// K5.  x: [B, C, H, W], r and out: [B, CO, H, W] (f32 or bf16, `in_bf16`);
// wd: [D, C], wu: [CO, 9D] (f32 or bf16, `w_bf16`); bd/ad: f32 [D]; bu/au:
// f32 [CO] (au may be null unless act == 2); act: 0 none, 1 relu, 2 prelu.
int bottleneck_s1_launch(const void* x, const void* r, const void* wd,
                         const void* bd, const void* ad, const void* wu,
                         const void* bu, const void* au, void* scratch,
                         void* out, int B, int C, int D, int CO, int H, int Wd,
                         int act, int in_bf16, int w_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (in_bf16)
    return launch<__nv_bfloat16>(x, r, wd, bd, ad, wu, bu, au, scratch, out,
                                 B, 1, C, D, CO, H, Wd, act, w_bf16, st);
  return launch<float>(x, r, wd, bd, ad, wu, bu, au, scratch, out, B, 1, C, D,
                       CO, H, Wd, act, w_bf16, st);
}

// K6.  x and out: [B, C, H, W]; wd: [U, D, C], wu: [U, C, 9D]; bd/ad: f32
// [U, D]; bu/au: f32 [U, C].
int bottleneck_chain_launch(const void* x, const void* wd, const void* bd,
                            const void* ad, const void* wu, const void* bu,
                            const void* au, void* scratch, void* out, int B,
                            int U, int C, int D, int H, int Wd, int act,
                            int in_bf16, int w_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (in_bf16)
    return launch<__nv_bfloat16>(x, nullptr, wd, bd, ad, wu, bu, au, scratch,
                                 out, B, U, C, D, C, H, Wd, act, w_bf16, st);
  return launch<float>(x, nullptr, wd, bd, ad, wu, bu, au, scratch, out, B, U,
                       C, D, C, H, Wd, act, w_bf16, st);
}

}  // extern "C"
