// K3: one stride-2 blaze block (or the 3x3/2 stem) as an implicit GEMM on
// 2x2 space-to-depth packed input, on the tensor cores.
//
// Replaces: bp_from_video_tpu/pallas/block_kernel.py `dense_s2_block`
// (pallas_call in `_block_call` at :180, body `_block_kernel` at :67);
// `trunk_apply` (:559) chains four of these.
//
// What it computes, per crop b:
//   out[O, p] = epi(bias[O] + W'[O, K] @ windows[K, p])  (p over h*w pixels)
// where the windows are the packed planes shifted by (0,0)/(0,1)/(1,0)/(1,1)
// (zero past the far edge: TFLite SAME pads lo=0, hi=1 at even sizes), in
// the "sliced" (K = 9*cin) or "expanded" (K = 4*rup8(4*cin)) row order of
// `pack_block_weights`.  Epilogue: the residual flavor (+ max of the four
// parity planes of the unrounded input on the first cin channels, ReLU) or
// the stem flavor ([P]ReLU, alpha null = ReLU).  Weights and windows are
// bf16 whatever the input type (an f32 input is rounded to bf16), the sums
// are f32, and the output has the input's type.
//
// Bound on this card: bytes.  At the flagship shapes a block does 70-270
// flops per byte it must move, under the ~295 at which bf16 tensor cores
// become the limit, so the design keeps every input byte to one read from
// device memory and spends no instructions on building windows:
//
// - One thread block = one crop x a band of `rows` whole output rows x an
//   M-tile of 16*MF output channels.  The launch plan (`make_plan`, the
//   same rule as `block_plan` in kernels/block.py) aims at <= 256 output
//   pixels a block (8 warps) and an input tile of <= 80 KB, and splits the
//   channels until the grid has two blocks per SM.
// - The block's input is loaded ONCE into shared memory, pixel-major:
//   [(rows+1) x (w+1) pixels][c4p channels] bf16, the extra row and column
//   the zero halo past the far edge (or the next band's first row).  The
//   load transposes through registers: a thread reads 8 channels x V
//   pixels along w (V up to 8: 16-byte loads of bf16) and writes V 16-byte
//   pixel pieces.  The pixel pitch is an odd number of 16-byte units, so
//   the 8 rows of an ldmatrix (8 neighbouring pixels) fall on 8 distinct
//   bank groups.  At the deep stages the kernel most likely waits on this
//   load (more loading warps made them faster; no counters show it), the
//   next thing to redesign (ROADMAP Queue 2).
// - No window matrix: the B operand of mma.m16n8k16 (bf16 in, f32 sums) is
//   read with ldmatrix straight from the tile.  A k-group of 8 window rows
//   always lies in one tap (sliced: cin % 8 == 0; expanded: 8 channels of
//   one shifted copy), so a lane's row address is
//   tile + pixel_base + kofs[group], kofs from a per-block table of byte
//   offsets (shift and channel), built once; nothing divides in the loop.
// - The A operand (weights) comes through a two-stage cp.async ring of
//   64-deep K-chunks (zero-filled past cout and K), read with ldmatrix.
// - The epilogue runs from the accumulator registers: bias, then residual
//   (bf16 input: the parity-plane max from the tile, whose values are the
//   input's own; f32 input: from device memory, unrounded) or [P]ReLU,
//   ragged channels and pixels masked, stored planar [B, cout, h, w].

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define KC 64                 // weight K-chunk per pipeline stage
#define WPITCH (KC + 8)       // bf16 per weight row in shared memory (144 B)
#define MAX_WARPS 8
#define PLAN_PIXELS 256       // output pixels a block aims at
#define TILE_BUDGET (80 * 1024)
#define TARGET_BLOCKS (2 * 132)
#define SMEM_MAX 232448

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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two neighbouring outputs (p even) in one store.
__device__ __forceinline__ void st_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// V consecutive values of one channel row (V-aligned) -> f32.
template <int V>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* f) {
  uint32_t u[V > 1 ? V / 2 : 1];
  if constexpr (V == 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    u[0] = q.x; u[1] = q.y; u[2] = q.z; u[3] = q.w;
  } else if constexpr (V == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    u[0] = q.x; u[1] = q.y;
  } else if constexpr (V == 2) {
    u[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    f[0] = __bfloat162float(*p);
    return;
  }
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

template <int V>
__device__ __forceinline__ void load_row(const float* p, float* f) {
  if constexpr (V >= 4) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(p)[i];
      f[4 * i] = q.x; f[4 * i + 1] = q.y; f[4 * i + 2] = q.z;
      f[4 * i + 3] = q.w;
    }
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    f[0] = q.x; f[1] = q.y;
  } else {
    f[0] = *p;
  }
}

// The block's input tile: [(rows+1) x (w+1) pixels][pitch] bf16 from the
// planar input, zero past the image.  An item is 8 channels x V pixels of
// one row.  For V >= 4 neighbouring threads take neighbouring channel
// groups of the same pixels (one 16-byte store each, on distinct bank
// groups), then the next V pixels, so the lanes that read one channel read
// neighbouring pieces of its row; for V <= 2 they take neighbouring pixels
// (coalesced narrow loads; the odd pitch keeps the stores apart).
template <int V, typename T>
__device__ __forceinline__ void load_tile(const T* xb, __nv_bfloat16* tile,
                                          int c4, int c4p, int pitch, int h,
                                          int w, int r0, int rows, int tid,
                                          int nthreads) {
  const int tw = w + 1, hw = h * w;
  const int cgroups = c4p / 8, nxc = w / V;
  const int items = cgroups * nxc * (rows + 1);
  for (int e = tid; e < items; e += nthreads) {
    int cg, rest;
    if (V >= 4) {               // channel groups fastest
      rest = e / cgroups;
      cg = e - rest * cgroups;
    } else {                    // pixels fastest: coalesced narrow loads
      cg = e / (nxc * (rows + 1));
      rest = e - cg * (nxc * (rows + 1));
    }
    const int yy = rest / nxc, x0 = (rest - yy * nxc) * V;
    const int gy = r0 + yy;
    float f[8][V];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (gy < h && cg * 8 + j < c4) {
        load_row<V>(xb + (long long)(cg * 8 + j) * hw + gy * w + x0, f[j]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) f[j][v] = 0.0f;
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      *reinterpret_cast<uint4*>(tile + (yy * tw + x0 + v) * pitch + cg * 8) =
          make_uint4(pack_bf16x2(f[0][v], f[1][v]),
                     pack_bf16x2(f[2][v], f[3][v]),
                     pack_bf16x2(f[4][v], f[5][v]),
                     pack_bf16x2(f[6][v], f[7][v]));
  }
  for (int e = tid; e < (rows + 1) * cgroups; e += nthreads) {  // x = w
    const int yy = e / cgroups, cg = e - yy * cgroups;
    *reinterpret_cast<uint4*>(tile + (yy * tw + w) * pitch + cg * 8) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// MF m16 fragments (16*MF channels) x NF n8 fragments (8*NF pixels) a warp;
// the block's warps split the pixels.
template <typename T, int MF, int NF>
__global__ void __launch_bounds__(32 * MAX_WARPS)
dense_s2_block_kernel(const T* __restrict__ x,
                      const __nv_bfloat16* __restrict__ wmat,
                      const float* __restrict__ bias,
                      const float* __restrict__ alpha, T* __restrict__ out,
                      int cin, int cout, int h, int w, int kdim, int expanded,
                      int resid, int rows, int c4p, int pitch) {
  constexpr int MT = 16 * MF;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* tile = wbuf + 2 * MT * WPITCH;
  const int tw = w + 1;                       // tile row: w pixels + halo
  const int npix = (rows + 1) * tw;
  int* kofs = reinterpret_cast<int*>(tile + npix * pitch);

  const int m0 = blockIdx.x * MT;
  const int r0 = blockIdx.y * rows;
  const int bi = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x;
  const int hw = h * w;
  const int c4 = 4 * cin;
  const T* xb = x + (long long)bi * c4 * hw;
  const int ksteps = (kdim + 15) / 16;
  const int nchunks = (ksteps + 3) / 4;
  const uint32_t wbuf_s = smem_u32(wbuf);
  const uint32_t tile_s = smem_u32(tile);
  const int pitch_b = pitch * 2;

  // Weight chunk c -> ring stage `stage`: rows past cout and columns past
  // kdim are zero-filled (kdim % 8 == 0, so a 16-byte piece is all in or
  // all out).
  auto load_w = [&](int c, int stage) {
    const uint32_t dst = wbuf_s + stage * MT * WPITCH * 2;
    for (int e = tid; e < MT * (KC / 8); e += nthreads) {
      const int m = e >> 3, seg = e & 7;
      const int k = c * KC + seg * 8;
      const bool ok = m0 + m < cout && k < kdim;
      const __nv_bfloat16* src =
          ok ? wmat + (long long)(m0 + m) * kdim + k : wmat;
      cp_async16(dst + (m * WPITCH + seg * 8) * 2, src, ok ? 16 : 0);
    }
    cp_async_commit();
  };
  load_w(0, 0);

  // k-group -> byte offset of its (shift, channel) in a tile pixel row.
  // Groups past kdim (K padded to a multiple of 16) meet zero weights and
  // read group 0's finite values.
  for (int g = tid; g < 2 * ksteps; g += nthreads) {
    const int gg = g * 8 < kdim ? g : 0;
    int shift, ch;
    if (expanded) {
      const int per = c4p / 8;                // groups per shifted copy
      const int s = gg / per;
      shift = (s >> 1) * tw + (s & 1);
      ch = (gg - s * per) * 8;
    } else {
      const int k = gg * 8, t = k / cin, c0 = k - t * cin;
      const int dy = t / 3, dx = t - 3 * (t / 3);
      shift = (dy >> 1) * tw + (dx >> 1);
      ch = ((dy & 1) * 2 + (dx & 1)) * cin + c0;
    }
    kofs[g] = shift * pitch_b + ch * 2;
  }

  // The input tile, rounded to bf16: 8 channels x V pixels of one row per
  // item, V the widest vector that divides w.
  const int vw = w % 8 == 0 ? 8 : w % 4 == 0 ? 4 : w % 2 == 0 ? 2 : 1;
  if (vw == 8)
    load_tile<8>(xb, tile, c4, c4p, pitch, h, w, r0, rows, tid, nthreads);
  else if (vw == 4)
    load_tile<4>(xb, tile, c4, c4p, pitch, h, w, r0, rows, tid, nthreads);
  else if (vw == 2)
    load_tile<2>(xb, tile, c4, c4p, pitch, h, w, r0, rows, tid, nthreads);
  else
    load_tile<1>(xb, tile, c4, c4p, pitch, h, w, r0, rows, tid, nthreads);

  // ldmatrix row addresses.  B (window) x4 = two n8 tiles x two k-groups:
  // lane i reads pixel (i>>4)*8 + (i&7) of the pair, k-group (i>>3)&1.
  // Pixel slots past the band read pixel 0 and are never stored.
  const int np = rows * w;
  const int wn0 = warp * NF * 8;
  int pb[NF / 2];
#pragma unroll
  for (int p = 0; p < NF / 2; ++p) {
    const int n = wn0 + (2 * p + (lane >> 4)) * 8 + (lane & 7);
    int yy = 0, xx = 0;
    if (n < np) {
      yy = n / w;
      xx = n - yy * w;
    }
    pb[p] = (yy * tw + xx) * pitch_b;
  }
  const int gsel = (lane >> 3) & 1;
  // A (weights) x4: rows (i&7) + ((i>>3)&1)*8, columns (i>>4)*8.
  const int a_off = (((lane & 7) + ((lane >> 3) & 1) * 8) * WPITCH +
                     (lane >> 4) * 8) * 2;

  float acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      load_w(c + 1, (c + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t wb = wbuf_s + (c & 1) * MT * WPITCH * 2 + a_off;
#pragma unroll
    for (int s = 0; s < KC / 16; ++s) {
      const int j = c * (KC / 16) + s;
      if (j < ksteps) {
        uint32_t a[MF][4];
#pragma unroll
        for (int mf = 0; mf < MF; ++mf)
          ldmatrix_x4(a[mf], wb + (mf * 16 * WPITCH + s * 16) * 2);
        const uint32_t tb = tile_s + kofs[2 * j + gsel];
        uint32_t b[NF][2];
#pragma unroll
        for (int p = 0; p < NF / 2; ++p) {
          uint32_t r[4];
          ldmatrix_x4(r, tb + pb[p]);
          b[2 * p][0] = r[0];
          b[2 * p][1] = r[1];
          b[2 * p + 1][0] = r[2];
          b[2 * p + 1][1] = r[3];
        }
#pragma unroll
        for (int mf = 0; mf < MF; ++mf)
#pragma unroll
          for (int nt = 0; nt < NF; ++nt) mma_bf16(acc[mf][nt], a[mf], b[nt]);
      }
    }
    __syncthreads();
  }

  // Epilogue.  Accumulator (mf, nt, q): channel m0 + mf*16 + (lane>>2) +
  // (q>>1)*8, pixel wn0 + nt*8 + (lane&3)*2 + (q&1).  The two pixels of a
  // lane are stored as one pair where w is even (same row, aligned).
  const int nvalid = min(rows, h - r0) * w;
  auto epi = [&](float v, int co, int gp, int tp) {
    v += bias[co];
    if (resid) {
      if (co < cin) {
        float m;
        if (sizeof(T) == 2) {                   // the tile holds x itself
          const __nv_bfloat16* t = tile + tp * pitch + co;
          m = __bfloat162float(t[0]);
#pragma unroll
          for (int q = 1; q < 4; ++q)
            m = fmaxf(m, __bfloat162float(t[q * cin]));
        } else {                                // f32: the unrounded input
          m = ld<T>(xb + (long long)co * hw + gp);
#pragma unroll
          for (int q = 1; q < 4; ++q)
            m = fmaxf(m, ld<T>(xb + (long long)(q * cin + co) * hw + gp));
        }
        v += m;
      }
      return fmaxf(v, 0.0f);
    }
    const float aco = alpha != nullptr ? alpha[co] : 0.0f;
    return v >= 0.0f ? v : v * aco;
  };
#pragma unroll
  for (int nt = 0; nt < NF; ++nt) {
    int gp[2], tp[2];
    bool ok[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = wn0 + nt * 8 + (lane & 3) * 2 + e;
      ok[e] = n < nvalid;
      const int yy = n / w, xx = n - yy * w;
      gp[e] = (r0 + yy) * w + xx;
      tp[e] = yy * tw + xx;
    }
    const bool pair = ok[1] && (w & 1) == 0;
#pragma unroll
    for (int mf = 0; mf < MF; ++mf) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int co = m0 + mf * 16 + (lane >> 2) + hh * 8;
        if (co >= cout || !ok[0]) continue;
        T* o = out + ((long long)bi * cout + co) * hw;
        const float v0 = epi(acc[mf][nt][hh * 2], co, gp[0], tp[0]);
        if (pair) {
          const float v1 = epi(acc[mf][nt][hh * 2 + 1], co, gp[1], tp[1]);
          st_pair(o + gp[0], v0, v1);
        } else {
          o[gp[0]] = st_cvt<T>(v0);
          if (ok[1])
            o[gp[1]] = st_cvt<T>(epi(acc[mf][nt][hh * 2 + 1], co, gp[1],
                                     tp[1]));
        }
      }
    }
  }
}

// -- launch plan (the rule of kernels/block.py `block_plan`) ----------------

struct Plan {
  int rows, bands, mf, m_tiles, nf, warps, c4p, pitch, smem;
};

static int cdiv(int a, int b) { return (a + b - 1) / b; }

// 0 on success; 1 (cudaErrorInvalidValue) for a shape the kernel does not
// take (rows wider than 128 pixels, or more shared memory than a block has).
static int make_plan(int b, int h, int w, int cin, int cout, int kdim,
                     int expanded, Plan* p) {
  if (w < 1 || w > PLAN_PIXELS || h < 1 || cout < 1) return 1;
  p->c4p = expanded ? cdiv(4 * cin, 8) * 8 : 4 * cin;
  const int p16 = p->c4p / 8;
  p->pitch = 8 * (p16 + (p16 % 2 == 0 ? 1 : 2));   // odd 16-byte units
  int rows = PLAN_PIXELS / w < h ? PLAN_PIXELS / w : h;
  auto tile = [&](int r) { return (r + 1) * (w + 1) * p->pitch * 2; };
  while (rows > 1 && tile(rows) > TILE_BUDGET) rows = cdiv(rows, 2);
  p->rows = rows;
  p->bands = cdiv(h, rows);
  const int c16 = cdiv(cout, 16);
  int mf = c16 < 4 ? c16 : 4;
  while (mf > 1 && b * p->bands * cdiv(c16, mf) < TARGET_BLOCKS) --mf;
  p->m_tiles = cdiv(c16, mf);
  p->mf = cdiv(c16, p->m_tiles);              // balance the M-tiles
  p->nf = rows * w > 128 ? 4 : 2;
  p->warps = cdiv(rows * w, 8 * p->nf);
  p->smem =
      2 * 16 * p->mf * WPITCH * 2 + tile(rows) + 4 * 2 * cdiv(kdim, 16);
  return p->smem <= SMEM_MAX ? 0 : 1;
}

template <typename T, int MF, int NF>
static void launch(const Plan& p, int b, const void* x, const void* wmat,
                   const void* bias, const void* alpha, void* out, int cin,
                   int cout, int h, int w, int kdim, int expanded, int resid,
                   cudaStream_t st) {
  auto kern = dense_s2_block_kernel<T, MF, NF>;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_MAX);
    attr = true;
  }
  dim3 grid(p.m_tiles, p.bands, b);
  kern<<<grid, 32 * p.warps, p.smem, st>>>(
      (const T*)x, (const __nv_bfloat16*)wmat, (const float*)bias,
      (const float*)alpha, (T*)out, cin, cout, h, w, kdim, expanded, resid,
      p.rows, p.c4p, p.pitch);
}

template <typename T>
static int dispatch(const Plan& p, int b, const void* x, const void* wmat,
                    const void* bias, const void* alpha, void* out, int cin,
                    int cout, int h, int w, int kdim, int expanded, int resid,
                    cudaStream_t st) {
#define K3_CASE(MF_, NF_)                                                   \
  if (p.mf == MF_ && p.nf == NF_) {                                        \
    launch<T, MF_, NF_>(p, b, x, wmat, bias, alpha, out, cin, cout, h, w,  \
                        kdim, expanded, resid, st);                        \
    return 0;                                                              \
  }
  K3_CASE(1, 2) K3_CASE(2, 2) K3_CASE(3, 2) K3_CASE(4, 2)
  K3_CASE(1, 4) K3_CASE(2, 4) K3_CASE(3, 4) K3_CASE(4, 4)
#undef K3_CASE
  return 1;
}

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// The launch plan of a shape, for the wrapper to hold against its own:
// out[9] = rows, bands, mf, m_tiles, nf, warps, c4p, pitch, smem.
int dense_s2_block_plan(int b, int h, int w, int cin, int cout, int kdim,
                        int expanded, int* out) {
  Plan p;
  const int err = make_plan(b, h, w, cin, cout, kdim, expanded, &p);
  const int v[9] = {p.rows, p.bands, p.mf, p.m_tiles, p.nf,
                    p.warps, p.c4p, p.pitch, p.smem};
  for (int i = 0; i < 9; ++i) out[i] = err ? 0 : v[i];
  return err;
}

// x: [B, 4*cin, h, w] (f32 or bf16, `in_bf16`); wmat: bf16 [cout, kdim];
// bias: f32 [cout]; alpha: f32 [cout] or null (ReLU); out: [B, cout, h, w]
// in the input type.
int dense_s2_block_launch(const void* x, const void* wmat, const void* bias,
                          const void* alpha, void* out, int b, int cin,
                          int cout, int h, int w, int kdim, int expanded,
                          int resid, int in_bf16, void* stream) {
  Plan p;
  if (make_plan(b, h, w, cin, cout, kdim, expanded, &p))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int err =
      in_bf16 ? dispatch<__nv_bfloat16>(p, b, x, wmat, bias, alpha, out, cin,
                                        cout, h, w, kdim, expanded, resid, st)
              : dispatch<float>(p, b, x, wmat, bias, alpha, out, cin, cout, h,
                                w, kdim, expanded, resid, st);
  if (err) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
