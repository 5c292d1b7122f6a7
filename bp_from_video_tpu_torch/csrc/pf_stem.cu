// K7: one layer of PhysFormer's stem -- a 3-D convolution, its 1x2x2
// max-pool, the folded BatchNorm's bias and the ReLU -- as one implicit
// GEMM on the tensor cores, writing only the pooled map.
//
// Replaces no TPU kernel: the JAX package has no PhysFormer.  It replaces
// the composition that `models/physformer.py` ran on cuDNN (the temporal
// taps copied beside each frame, a padded conv writing the full-resolution
// map, a max-pool reading it back, then bias and ReLU), which spent about
// 45 of its 72 ms (NVIDIA H100, 64 clips of 160 frames) moving bytes that
// this kernel never writes.
//
// What it computes, per frame f of a clip of `t_len` frames (bf16 in, f32
// sums, one rounding to bf16 at the end):
//
// - stem1 / stem2 (`taps`): x [frames, h, w, cin] channels-last, the pooled
//   output of the layer before.  out[f, i, j, n] = relu(bias[n] +
//   max over the 2x2 pixels (2i+a, 2j+b) of sum over (dt, ky, kx, c) of
//   x[f+dt-1, 2i+a+ky-1, 2j+b+kx-1, c] * wk[n, ((dt*3+ky)*3+kx)*cin + c]),
//   reading zero past the frame's edges and past the clip's two ends.
// - stem0 (`packed`): x [frames, h, w, 3], the standardised clip.  The 5x5
//   conv runs as a 3x3 conv over the 2x2-packed frame (16 channels, the
//   last 4 zero) whose 96 product columns n = (oct*4 + pos)*8 + i are the
//   four pool positions pos of output channel oct*8 + i
//   (`models/physformer._packed_stem0`); the pool is the max over pos.
//
// Bound on this card (NVIDIA H100): operations for stem1 and stem2 (2.6
// TFLOP each at 64 clips of 160 frames, ~220 flops per byte moved), bytes
// for stem0 (3 GB).  The design keeps every byte it can out of device
// memory and feeds the tensor cores from shared memory:
//
// - Persistent blocks, one an SM.  The weights (the block's slice of the
//   columns) are copied into shared memory once and stay: stem0 27 KB,
//   stem1 62 KB, stem2 two blocks of 122 KB, each half the columns.  They
//   are fenced for the async proxy once they land (`fence_proxy_async`).
// - Input: bands of output rows.  stem1 and stem2 walk a clip's frames in
//   order for a band (a unit: one clip, one band, 40 frames) through a
//   ring of four frame bands: output frame t reads frames t-1, t, t+1 in
//   place while frame t+2 loads, so each frame band is copied once, not
//   three times.  stem0 double-buffers whole tiles.  Copies are cp.async,
//   pixel-major, the halo and the clip's ends zero-filled by the copy
//   itself (nothing is padded or copied in device memory).  A pixel's pitch
//   is an odd number of 16-byte units, so the 8 rows of an ldmatrix (8
//   neighbouring pixels) fall on 8 bank groups.
// - The product: M = output pixels, N = output channels, K = taps x
//   channels in k-groups of 8 channels of one tap.  Warpgroup MMAs
//   (wgmma.mma_async m64nNk16, bf16 in, f32 sums): A (the windows) in
//   registers, read by each warp with ldmatrix straight from the frame band
//   at (pixel + a per-group byte offset from a table built once, + the
//   ring slot of the group's frame), the next k-step's while the tensor
//   cores run this one; B (the weights) read by the tensor cores from
//   shared memory, laid out in 8x16-byte core matrices, once for the
//   warpgroup's four warps.
// - Epilogue from the accumulators: the 2x2 max (taps: an m16 slice's rows
//   0-7 and 8-15 are two output rows, one register apart; the horizontal
//   neighbour is the lane 4 away, one shuffle; packed: the four positions
//   are four column blocks of the same thread), the bias in f32, ReLU, one
//   rounding to bf16; the warp's pooled pixels are staged in shared memory
//   and stored as whole 16-byte pieces (they are contiguous channels-last).
//
// Exports only the extern "C" entries at the end; everything else has
// internal linkage.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kSmemMax = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes, of which src_bytes are read and the rest zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Orders this thread's earlier writes to shared memory (the generic proxy;
// cp.async included) before later reads of it by the tensor cores (the
// async proxy, through which wgmma reads B).  The PTX ISA requires it
// between writing a wgmma operand in shared memory and the wgmma that
// reads it; a barrier alone does not order the two proxies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous MMAs that write it.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Shared-memory matrix descriptor of a K-major operand without swizzle:
// core matrices of 8 rows x 16 bytes (128 contiguous bytes), `lbo` bytes
// between the two along K, `sbo` between neighbours along N.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// D[64 x NS] += A[64 x 16] (registers: a warp's 16 rows, mma.m16n8k16's A
// fragment) x B[16 x NS] (shared, `desc`).
template <int NS>
struct Wgmma;

template <>
struct Wgmma<48> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23}, "
        "{%24, %25, %26, %27}, %28, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<96> {
  static __device__ __forceinline__ void run(float* d, const uint32_t* a,
                                             uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47}, "
        "{%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

__device__ __forceinline__ void st_relu2(__nv_bfloat16* p, float a, float b) {
  __nv_bfloat162 v = __floats2bfloat162_rn(fmaxf(a, 0.f), fmaxf(b, 0.f));
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

// One layer's compile-time shape.  PACK: stem0 on the 2x2-packed clip,
// whole tiles double-buffered; else a conv three frames deep over a pooled
// map, through the ring of frame bands.  H, W: the layer's input frame.  A
// warp holds MT m16 slices of pixels (taps: 2 rows x 8 columns each;
// packed: 16 packed pixels of a row); a block's warpgroups multiply them
// by the block's NS columns, the N columns split over BSPLIT blocks.
template <bool PACK_, int CIN_, int COUT_, int H_, int W_, int WARPS_,
          int MT_, int BSPLIT_>
struct Layer {
  static constexpr bool PACK = PACK_;
  static constexpr int CIN = CIN_, COUT = COUT_, H = H_, W = W_,
                       WARPS = WARPS_, MT = MT_, BSPLIT = BSPLIT_;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int CS = PACK ? 16 : CIN;         // a tile pixel's channels
  static constexpr int C8 = CS / 8;
  static constexpr int PITCH = (C8 % 2) ? CS : CS + 8;  // bf16, odd 16 B units
  static constexpr int PITCH_B = 2 * PITCH;
  static constexpr int G_DT = 9 * C8;                // k-groups of a frame
  static constexpr int GROUPS = (PACK ? 1 : 3) * G_DT;
  static constexpr int KS = (GROUPS + 1) / 2;        // k-steps of 16
  static constexpr int K = 16 * KS;                  // wk's row length
  static constexpr int N = PACK ? 4 * COUT : COUT;   // product columns
  static constexpr int NS = N / BSPLIT;              // columns a block
  static constexpr int OCS = PACK ? NS / 4 : NS;     // output channels a block
  static constexpr int NBA = 2;                      // A fragment buffers
  static constexpr int W_B = KS * NS * 32;           // the resident weights
  static constexpr int HO = H / 2, WO = W / 2;       // output (pooled) frame
  static constexpr int WPX = 16 * MT;                // pixels a warp
  static constexpr int OPX = PACK ? WPX : WPX / 4;   // pooled pixels a warp
  static constexpr int PER_ROW = PACK ? WO / WPX : W / (8 * MT);
  static constexpr int ROWS = WARPS / PER_ROW;       // pooled rows a band
  static constexpr int TROWS = PACK ? ROWS + 2 : 2 * ROWS + 2;
  static constexpr int TCOLS = PACK ? WO + 2 : W + 2;
  static constexpr int BANDS = HO / ROWS;            // bands a frame
  static constexpr int FRAME_B = TROWS * TCOLS * PITCH_B;  // one slot
  static constexpr int SLOTS = PACK ? 2 : 4;
  static constexpr int EPI_B = OPX * OCS * 2;        // a warp's pooled output
  static constexpr int CHUNK_T = 40;                 // frames a unit (taps)
  static constexpr int SMEM =
      W_B + SLOTS * FRAME_B + WARPS * EPI_B + 2 * KS * 4;
  static_assert(PACK ? CIN == 3 : CIN % 8 == 0, "input channels");
  static_assert(WARPS % 4 == 0 && N % BSPLIT == 0 && NS % 8 == 0, "columns");
  static_assert(!PACK || (BSPLIT == 1 && NS % 32 == 0), "pool positions");
  static_assert((PACK ? WO % WPX : W % (8 * MT)) == 0 && H % 2 == 0, "frame");
  static_assert(ROWS >= 1 && PER_ROW * ROWS == WARPS, "warps");
  static_assert(HO % ROWS == 0, "bands");
  static_assert(EPI_B % 16 == 0 && (OCS * 2) % 16 == 0, "16-byte stores");
  static_assert(SMEM <= kSmemMax, "shared memory");
};

// stem0: 3 -> 24 at 5x5 on 128x128 (96 product columns, K = 144); stem1:
// 24 -> 48 at 3x3x3 on 64x64 (K = 656, the last 8 zero weights); stem2:
// 48 -> 96 at 3x3x3 on 32x32 (K = 1296), each block 48 of the columns.
using L0 = Layer<true, 3, 24, 128, 128, 8, 2, 1>;
using L1 = Layer<false, 24, 48, 64, 64, 16, 2, 1>;
using L2 = Layer<false, 48, 96, 32, 32, 8, 1, 2>;

// The block's columns of the weights (rows cs * NS ...) into shared memory
// as core matrices: k-step s, column block n/8, k half, 8 rows x 16 bytes;
// landed and fenced for the tensor cores before anything else is loaded
// (the barrier before the first product then orders them for every
// thread).
template <class L>
__device__ __forceinline__ void load_weights(const __nv_bfloat16* wk,
                                             uint32_t s_w, int cs, int tid) {
  constexpr int PIECES = 2 * L::KS;                  // 16 bytes each a row
  const __nv_bfloat16* src0 = wk + (size_t)cs * L::NS * L::K;
  for (int e = tid; e < L::NS * PIECES; e += L::THREADS) {
    const int n = e / PIECES, q = e - n * PIECES;
    cp_async16(s_w + (q >> 1) * L::NS * 32 + (n >> 3) * 256 + (q & 1) * 128 +
                   (n & 7) * 16,
               src0 + (size_t)n * L::K + q * 8, 16);
  }
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
}

// stem0: frame f's band `band` of the 2x2-packed clip into slot `dst`:
// packed pixel (pr, pc) holds in words 0-2 image row 2*ipr's pixels
// (2*ipc, 2*ipc+1), in words 3-5 row 2*ipr+1's, words 6-7 zero, so that
// packed channel (p*2+q)*3 + c is pixel (2i+p, 2j+q)'s channel c.
template <class L>
__device__ __forceinline__ void load_packed(const __nv_bfloat16* x,
                                            uint32_t dst, int f, int band,
                                            int tid) {
  const __nv_bfloat16* xf = x + (size_t)f * L::H * L::W * 3;
  constexpr int ITEMS = L::TROWS * L::TCOLS * 8;
  for (int e = tid; e < ITEMS; e += L::THREADS) {
    const int w8 = e & 7, px = e >> 3;
    const int pr = px / L::TCOLS, pc = px - pr * L::TCOLS;
    const int ipr = band * L::ROWS - 1 + pr, ipc = pc - 1;
    const int odd = w8 >= 3;
    const bool ok =
        w8 < 6 && ipr >= 0 && ipr < L::HO && ipc >= 0 && ipc < L::WO;
    const __nv_bfloat16* src =
        ok ? xf + (2 * ipr + odd) * L::W * 3 + 6 * ipc + 2 * (w8 - 3 * odd)
           : x;
    cp_async4(dst + px * L::PITCH_B + w8 * 4, src, ok ? 4 : 0);
  }
}

// stem1/stem2: frame f's band `band` (with its halo) into slot `dst`, all
// zero when the frame lies past the clip (`valid` false).
template <class L>
__device__ __forceinline__ void load_band(const __nv_bfloat16* x,
                                          uint32_t dst, int f, bool valid,
                                          int band, int tid) {
  constexpr int Q = L::CIN / 8;                      // 16-byte pieces a pixel
  constexpr int ITEMS = L::TROWS * L::TCOLS * Q;
  for (int e = tid; e < ITEMS; e += L::THREADS) {
    const int q = e % Q, px = e / Q;
    const int yy = px / L::TCOLS, xx = px - yy * L::TCOLS;
    const int iy = band * 2 * L::ROWS - 1 + yy, ix = xx - 1;
    const bool ok = valid && iy >= 0 && iy < L::H && ix >= 0 && ix < L::W;
    const __nv_bfloat16* src =
        ok ? x + (((size_t)f * L::H + iy) * L::W + ix) * L::CIN + q * 8 : x;
    cp_async16(dst + px * L::PITCH_B + q * 16, src, ok ? 16 : 0);
  }
}

// Byte offset of k-step ks's window (the lane's k half) from its pixel in
// the ring: the group's spatial offset and the slot of its frame,
// ((t3 + dt) & 3) for tap dt (t3 = t + 3 for output frame t; stem0 passes
// the buffer's index, its taps all dt 0).
template <class L>
__device__ __forceinline__ uint32_t window(const int* s_off, int ks, int hsel,
                                           int t3) {
  const uint32_t v = (uint32_t)s_off[2 * ks + hsel];
  return (v & 0x0FFFFFFFu) + ((t3 + (int)(v >> 28)) & 3) * L::FRAME_B;
}

// One k-step's MMAs from A fragments `a` and the weights' descriptor, then
// the fragments at window offset `off` into `a_next` once the MMAs that
// read them (NBA k-steps back) are done.
template <class L>
__device__ __forceinline__ void mma_step(float (&acc)[L::MT][L::NS / 2],
                                         const uint32_t (&a)[L::MT][4],
                                         uint32_t (&a_next)[L::MT][4],
                                         uint64_t desc, uint32_t ring,
                                         const uint32_t (&a_pix)[L::MT],
                                         uint32_t off, bool more) {
  wgmma_fence();
#pragma unroll
  for (int mi = 0; mi < L::MT; ++mi) Wgmma<L::NS>::run(acc[mi], a[mi], desc);
  wgmma_commit();
  wgmma_wait<L::NBA - 1>();
  if (more) {
#pragma unroll
    for (int mi = 0; mi < L::MT; ++mi)
      ldmatrix_x4(a_next[mi], ring + a_pix[mi] + off);
  }
}

// The whole product of one output (frame or tile): KS k-steps from the
// ring (or buffer) and the resident weights at `s_w`.
template <class L>
__device__ __forceinline__ void gemm(float (&acc)[L::MT][L::NS / 2],
                                     uint32_t ring, int t3, uint32_t s_w,
                                     const uint32_t (&a_pix)[L::MT],
                                     const int* s_off, int hsel) {
  uint32_t a[L::NBA][L::MT][4];
  const uint64_t desc0 = smem_desc(s_w, 128, 256);
  const uint32_t off0 = window<L>(s_off, 0, hsel, t3);
#pragma unroll
  for (int mi = 0; mi < L::MT; ++mi)
    ldmatrix_x4(a[0][mi], ring + a_pix[mi] + off0);
#pragma unroll
  for (int s = 0; s < L::KS; ++s) {
    const bool more = s + 1 < L::KS;
    const uint32_t off = more ? window<L>(s_off, s + 1, hsel, t3) : 0u;
    // Descriptor address field: bytes / 16; a k-step is NS * 32 bytes.
    mma_step<L>(acc, a[s % L::NBA], a[(s + 1) % L::NBA],
                desc0 + (uint64_t)(s * L::NS * 2), ring, a_pix, off, more);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mi = 0; mi < L::MT; ++mi)
#pragma unroll
    for (int j = 0; j < L::NS / 2; ++j) fence_operand(acc[mi][j]);
}

// The warp's pooled pixels from the accumulators (max, bias, ReLU, one
// rounding) into its staging area, then to `o` (the first pooled pixel's
// channel slice in device memory; the pixels follow COUT channels apart)
// in 16-byte pieces.  acc[mi][4 j + r]: m16 slice mi, column block j; r
// 0-1 row gid, 2-3 row gid + 8, columns 2 tig + 0-1.
template <class L>
__device__ __forceinline__ void epilogue(const float (&acc)[L::MT][L::NS / 2],
                                         const float* __restrict__ bias,
                                         __nv_bfloat16* o,
                                         __nv_bfloat16* stage, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  __syncwarp();
  if constexpr (L::PACK) {
#pragma unroll
    for (int mi = 0; mi < L::MT; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int oc = 0; oc < L::NS / 32; ++oc) {
          // Column blocks oc*4 + pos: the four pool positions.
          float v0 = acc[mi][16 * oc + 2 * hh];
          float v1 = acc[mi][16 * oc + 2 * hh + 1];
#pragma unroll
          for (int pos = 1; pos < 4; ++pos) {
            v0 = fmaxf(v0, acc[mi][16 * oc + 4 * pos + 2 * hh]);
            v1 = fmaxf(v1, acc[mi][16 * oc + 4 * pos + 2 * hh + 1]);
          }
          const int c = oc * 8 + 2 * tig;
          const float2 bb = *reinterpret_cast<const float2*>(bias + c);
          st_relu2(stage + (16 * mi + gid + 8 * hh) * L::OCS + c, v0 + bb.x,
                   v1 + bb.y);
        }
  } else {
#pragma unroll
    for (int mi = 0; mi < L::MT; ++mi)
#pragma unroll
      for (int j = 0; j < L::NS / 8; ++j) {
        // Rows gid and gid + 8 are output rows row0 and row0 + 1; the
        // pixel beside (column x ^ 1) is the lane 4 away.
        float v0 = fmaxf(acc[mi][4 * j], acc[mi][4 * j + 2]);
        float v1 = fmaxf(acc[mi][4 * j + 1], acc[mi][4 * j + 3]);
        v0 = fmaxf(v0, __shfl_xor_sync(0xffffffffu, v0, 4));
        v1 = fmaxf(v1, __shfl_xor_sync(0xffffffffu, v1, 4));
        if (!(gid & 1)) {
          const int c = 8 * j + 2 * tig;
          const float2 bb = *reinterpret_cast<const float2*>(bias + c);
          st_relu2(stage + (4 * mi + (gid >> 1)) * L::OCS + c, v0 + bb.x,
                   v1 + bb.y);
        }
      }
  }
  __syncwarp();
  constexpr int PP = L::OCS * 2 / 16;                // 16-byte pieces a pixel
  for (int v = lane; v < L::OPX * PP; v += 32) {
    const int p = v / PP, q = v - p * PP;
    *reinterpret_cast<uint4*>(o + (size_t)p * L::COUT + q * 8) =
        reinterpret_cast<const uint4*>(stage)[v];
  }
}

template <class L>
__device__ __forceinline__ void zero(float (&acc)[L::MT][L::NS / 2]) {
#pragma unroll
  for (int mi = 0; mi < L::MT; ++mi)
#pragma unroll
    for (int j = 0; j < L::NS / 2; ++j) acc[mi][j] = 0.f;
}

template <class L>
__global__ void __launch_bounds__(L::THREADS, 1)
    pf_stem_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ wk,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, int nframes, int t_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_w = smem_u32(smem);
  const uint32_t ring = s_w + L::W_B;
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(
      smem + L::W_B + L::SLOTS * L::FRAME_B);
  int* s_off = reinterpret_cast<int*>(smem + L::W_B + L::SLOTS * L::FRAME_B +
                                      L::WARPS * L::EPI_B);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lj = lane >> 3, lr = lane & 7, hsel = lj >> 1;
  // The block's column slice (stem2: half the columns a block).
  const int cs = blockIdx.x % L::BSPLIT;
  stage += warp * (L::EPI_B / 2);

  // k-group g's window from its pixel: tap (ky, kx) of frame dt (bits
  // 28-31), 8 channels c8.  The padding group (stem1's 82nd) reads group 0
  // and meets zero weights.
  for (int g = tid; g < 2 * L::KS; g += L::THREADS) {
    const int gg = g < L::GROUPS ? g : 0;
    const int dt = gg / L::G_DT, r = gg - dt * L::G_DT;
    const int tap = r / L::C8, c8 = r - tap * L::C8;
    s_off[g] = ((tap / 3 * L::TCOLS + tap % 3) * L::PITCH_B + c8 * 16) |
               (dt << 28);
  }

  // The warp's pixels: taps, two output rows (row0, row0 + 1) x 8 MT
  // columns from x0 (slice mi: columns x0 + 8 mi ..., A's rows 0-7 the
  // first row, 8-15 the second); packed, 16 MT packed pixels of packed row
  // row0 from x0 (slice mi: x0 + 16 mi ...).  ldmatrix: lane -> matrix lj,
  // row lr; matrices 1 and 3 hold A's rows 8-15, 2 and 3 its k 8-15.
  const int prow = warp / L::PER_ROW;                // pooled row in a band
  const int x0 = (warp % L::PER_ROW) * (L::PACK ? L::WPX : 8 * L::MT);
  uint32_t a_pix[L::MT];
#pragma unroll
  for (int mi = 0; mi < L::MT; ++mi)
    a_pix[mi] =
        L::PACK
            ? (prow * L::TCOLS + x0 + 16 * mi + lr + 8 * (lj & 1)) * L::PITCH_B
            : ((2 * prow + (lj & 1)) * L::TCOLS + x0 + 8 * mi + lr) *
                  L::PITCH_B;
  const int ox0 = L::PACK ? x0 : x0 / 2;             // first pooled column
  const float* bias_cs = bias + cs * L::OCS;
  float acc[L::MT][L::NS / 2];

  if constexpr (L::PACK) {
    const int ntiles = nframes * L::BANDS;
    int tile = blockIdx.x;
    if (tile >= ntiles) return;
    load_weights<L>(wk, s_w, 0, tid);
    load_packed<L>(x, ring, tile / L::BANDS, tile % L::BANDS, tid);
    cp_async_commit();
    for (int i = 0; tile < ntiles; ++i, tile += gridDim.x) {
      cp_async_wait<0>();
      __syncthreads();             // this tile is in; the other buffer free
      const int next = tile + gridDim.x;
      if (next < ntiles)
        load_packed<L>(x, ring + ((i + 1) & 1) * L::FRAME_B,
                       next / L::BANDS, next % L::BANDS, tid);
      cp_async_commit();
      zero<L>(acc);
      gemm<L>(acc, ring, i & 1, s_w, a_pix, s_off, hsel);
      const int f = tile / L::BANDS, oy = (tile % L::BANDS) * L::ROWS + prow;
      epilogue<L>(acc, bias_cs,
                  out + (((size_t)f * L::HO + oy) * L::WO + ox0) * L::COUT,
                  stage, lane);
    }
  } else {
    const int clips = nframes / t_len;
    const int chunks = (t_len + L::CHUNK_T - 1) / L::CHUNK_T;
    const int units = clips * chunks * L::BANDS;     // a column slice's
    const int stride = gridDim.x / L::BSPLIT;
    int u = blockIdx.x / L::BSPLIT;
    if (u >= units) return;
    load_weights<L>(wk, s_w, cs, tid);
    for (; u < units; u += stride) {
      const int band = u % L::BANDS, rest = u / L::BANDS;
      const int ch = rest % chunks, fb = (rest / chunks) * t_len;
      const int t0 = ch * L::CHUNK_T;
      const int t1 = min(t0 + L::CHUNK_T, t_len);
      __syncthreads();             // the last unit's frames are done with
#pragma unroll
      for (int dt = -1; dt <= 1; ++dt) {
        const int t = t0 + dt;
        load_band<L>(x, ring + ((t + 4) & 3) * L::FRAME_B, fb + t,
                     t >= 0 && t < t_len, band, tid);
      }
      cp_async_commit();
      for (int t = t0; t < t1; ++t) {
        cp_async_wait<0>();
        __syncthreads();           // frame t + 1 is in; slot (t + 2) & 3 free
        if (t + 1 < t1)
          load_band<L>(x, ring + ((t + 2) & 3) * L::FRAME_B, fb + t + 2,
                       t + 2 < t_len, band, tid);
        cp_async_commit();
        zero<L>(acc);
        gemm<L>(acc, ring, t + 3, s_w, a_pix, s_off, hsel);
        const int oy = band * L::ROWS + prow;
        epilogue<L>(acc, bias_cs,
                    out + (((size_t)(fb + t) * L::HO + oy) * L::WO + ox0) *
                              L::COUT + cs * L::OCS,
                    stage, lane);
      }
    }
  }
}

template <class L>
int launch(const void* x, const void* wk, const void* bias, void* out,
           int nframes, int t_len, int h, int w, cudaStream_t st) {
  if (h != L::H || w != L::W || nframes < 1 || t_len < 1 || nframes % t_len)
    return (int)cudaErrorInvalidValue;
  auto kern = pf_stem_kernel<L>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int work =
      L::PACK ? nframes * L::BANDS
              : nframes / t_len * ((t_len + L::CHUNK_T - 1) / L::CHUNK_T) *
                    L::BANDS * L::BSPLIT;
  int grid = (sms / L::BSPLIT) * L::BSPLIT;
  if (work < grid) grid = work;
  kern<<<grid, L::THREADS, L::SMEM, st>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)wk, (const float*)bias,
      (__nv_bfloat16*)out, nframes, t_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// x: bf16 [nframes, h, w, cin] (clips of t_len frames, channels last);
// wk: bf16 [N, K]; bias: f32 [cout]; out: bf16 [nframes, h/2, w/2, cout].
int pf_stem_launch(const void* x, const void* wk, const void* bias, void* out,
                   int nframes, int t_len, int h, int w, int cin, int cout,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (cin == 3 && cout == 24)
    return launch<L0>(x, wk, bias, out, nframes, t_len, h, w, st);
  if (cin == 24 && cout == 48)
    return launch<L1>(x, wk, bias, out, nframes, t_len, h, w, st);
  if (cin == 48 && cout == 96)
    return launch<L2>(x, wk, bias, out, nframes, t_len, h, w, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
