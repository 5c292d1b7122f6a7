// K5 and K6: the face-mesh bottleneck residual unit, alone (K5) or as a
// chain of U same-shape units (K6).
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
// bf16 x, residual and weights only, on the tensor cores (the flagship
// mesh path): the wrapper refuses any other dtype, and a graph of another
// dtype binds the plain units at compile.  Bound on this card: bytes (one
// unit does about 40 flops per byte at C = 16, D = 8, far under the ~295 at
// which bf16 tensor cores become the limit), so the design keeps each
// activation to one pass through device memory a unit and spends few
// instructions per output:
//
// - One launch per unit; K6 is U launches from one C-entry call,
//   ping-ponging between `out` and one activation buffer of the wrapper's.
//   Each unit's activation goes through the 50 MB L2 (the 128^2 stage's is
//   33.5 MB in bf16).  No halo is recomputed across units: the TPU chained
//   units to save per-call DMA, which launches back to back do not cost.
// - One block = G crops x a band of R output rows x CB output channels
//   (`make_tc_plan`, the rule of kernels/bottleneck.py `bottleneck_plan`):
//   about 256 output pixels, 8 warps where the pixels and channels allow
//   (channel warps make up for few pixels), at most 113 KB of shared
//   memory (two blocks an SM); the channels are split across blocks (each
//   split recomputes z), then the pixels cut, until the grid has two
//   blocks an SM.
// - Weights, biases and slopes come by cp.async at the start: Wd whole,
//   bd/ad/bu/au into shared memory, and all of Wu's 64-deep K-chunks where
//   they fit (else a three-stage ring), so no thread waits on device
//   memory before it has started its share of the x tile loads.
// - The x tile is loaded once, pixel-major bf16: G x (R+2) x (w+2) pixels,
//   a zero border where the image ends and the next band's row as halo.
//   A thread reads two items of 8 channels x 4 pixels (planar rows, the
//   lanes on neighbouring pixels), transposes them with byte permutes and
//   writes 16-byte pixel pieces at an odd pitch of 16-byte units, so
//   neither the stores nor ldmatrix rows collide on banks.
// - GEMM1 on mma.sync.m16n8k16 (bf16 in, f32 sums): z[pix, D] =
//   x_tile[pix, C] . Wd^T over the whole padded tile (the one-pixel border
//   is recomputed, not U pixels).  Wd [D, C] row-major is already the
//   col-major B operand, so no weight is repacked.  Epilogue: + bd, PReLU,
//   0 at pixels outside the image (the padding of z; a byte table built
//   once), bf16 into a z tile of the same geometry.
// - GEMM2 as a shifted-view implicit GEMM: y[pix, C'] = sum over taps t of
//   z_tile[pix + shift_t, D] . Wu[C', tD:(t+1)D]^T.  A (z) is read with
//   ldmatrix at per-lane pixel addresses (a table built once) plus a
//   per-k-group byte offset (tap shift and channel): no window matrix.
// - D = 8 (the 128^2 stage) needs neither z padded to 16 channels nor
//   mma.m16n8k8: a k16 step's two k-groups of 8 may come from two taps,
//   since each lane's row address carries its own group's offset, so K =
//   9D = 72 runs as 4.5 k16 steps, the last half against zero weights (11%
//   extra work, against 100% for padding z and two instructions a step
//   for k8).  GEMM1 at D = 8 is one n8 tile.
// - Epilogue: the raw f32 sums are staged [CB][pixels] in shared memory
//   over the x tile; one loop over (channel, pixel pair) then adds bu and
//   the residual (read from device memory, where the unit's own input is
//   still in L2), applies the activation, rounds once and stores pairs of
//   neighbouring pixels.  A compact loop, not an unrolled epilogue per
//   accumulator: the code a block runs once stays short.
// - Integer divisions by a block's geometry go through a f32 reciprocal
//   (`Div`), a few instructions each.
// - What bounds it in practice is latency, not bytes: a block's phases
//   (copies started, tile load, GEMM1, GEMM2, epilogue) run one after
//   another and overlap only across the 2-4 blocks an SM holds.  A block
//   walking several bands with the next tile in flight is the next step.
// - C and D must be multiples of 8 (16-byte pieces); a shape without a
//   plan raises in the wrapper.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MAX_SMEM 232448

// ---------------------------------------------------------------------------
// The kernel: one unit per launch on the tensor cores.
// ---------------------------------------------------------------------------

#define TC_MAX_WARPS 8         // warps a block: 8 where the channels allow
#define TC_PIXELS 256          // output pixels a block aims at
#define TC_MIN_PIXELS 64       // ... and the fewest it is cut down to
#define TC_TARGET_BLOCKS (2 * 132)
#define TC_SMEM_BUDGET (113 * 1024)   // two blocks an SM
#define WKC 64                 // Wu K-chunk of one ring stage
#define WSTAGES 3              // ring stages: two chunks in flight
#define WKP (WKC + 8)          // bf16 per Wu row in shared memory (144 B)

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x / d for 0 <= x < 2^22 through a f32 reciprocal and one correction:
// a few instructions where an integer division inlines about twenty.
struct Div {
  int d;
  float inv;
};

__device__ __forceinline__ Div make_div(int d) { return {d, 1.0f / d}; }

__device__ __forceinline__ int operator/(int x, const Div& v) {
  int q = __float2int_rz(__int2float_rn(x) * v.inv);
  const int rem = x - q * v.d;
  q += rem >= v.d ? 1 : rem < 0 ? -1 : 0;
  return q;
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

__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
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

// V consecutive bf16 of one channel row (V-aligned), packed two a word.
template <int V>
__device__ __forceinline__ void load_row(const bf16* p, uint32_t* u) {
  if constexpr (V == 4) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    u[0] = q.x;
    u[1] = q.y;
  } else if constexpr (V == 2) {
    u[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    u[0] = *reinterpret_cast<const unsigned short*>(p);
  }
}

// One tile item: 8 channels x V pixels of one image row, read planar.
template <int V>
struct TileItem {
  uint32_t u[8][V > 1 ? V / 2 : 1];
  int dst;                                  // tile pixel of the first pixel
};

// The block's x tile: G crops x (R+2) rows x (W+2) pixels, pitch bf16 a
// pixel, from planar x.  Tile row yy is image row r0-1+yy, tile column xx
// image column xx-1; pixels outside the image, channels past C and crops
// past B are zero (the zero columns left and right of the image are the
// caller's).  An item is 8 channels x V pixels of one row (V <= 4),
// transposed in registers (byte permutes of the packed words) into V
// 16-byte pixel pieces; a thread loads two items before it stores either.
// Pixels go fastest across threads, so a warp's loads of one channel are
// contiguous (a band of whole rows is contiguous in the plane), and the
// odd pitch keeps the lanes' 16-byte stores on distinct bank groups.
template <int V>
__device__ __forceinline__ void load_x_tile(const bf16* x, bf16* tile, int B,
                                            int C, int cgroups, int pitch,
                                            int H, int W, int b0, int G,
                                            int r0, int R, int tid,
                                            int nthreads) {
  const int twp = W + 2, rows = R + 2, cs = rows * twp, nxc = W / V;
  const int per_cg = G * rows * nxc;
  const int items = cgroups * per_cg;
  const Div d_cg = make_div(per_cg), d_g = make_div(rows * nxc),
            d_x = make_div(nxc);
  const long long hw = (long long)H * W;
  auto load = [&](int e, TileItem<V>& it) {
    const int cg = e / d_cg, rest = e - cg * per_cg;
    const int g = rest / d_g, rr = rest - g * (rows * nxc);
    const int yy = rr / d_x, x0 = (rr - yy * nxc) * V;
    const int gy = r0 - 1 + yy, b = b0 + g;
    const bool ok = e < items && b < B && gy >= 0 && gy < H;
    it.dst = (g * cs + yy * twp + 1 + x0) * pitch + cg * 8;
    const bf16* src = x + ((long long)b * C + cg * 8) * hw +
                      (long long)gy * W + x0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (ok && cg * 8 + j < C) {
        load_row<V>(src + j * hw, it.u[j]);
      } else {
#pragma unroll
        for (int v = 0; v < (V > 1 ? V / 2 : 1); ++v) it.u[j][v] = 0u;
      }
    }
  };
  auto store = [&](const TileItem<V>& it) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      uint32_t w4[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (V == 1) {
          w4[k] = it.u[2 * k][0] | (it.u[2 * k + 1][0] << 16);
        } else {
          w4[k] = __byte_perm(it.u[2 * k][v >> 1], it.u[2 * k + 1][v >> 1],
                              (v & 1) ? 0x7632 : 0x5410);
        }
      }
      *reinterpret_cast<uint4*>(tile + it.dst + v * pitch) =
          make_uint4(w4[0], w4[1], w4[2], w4[3]);
    }
  };
  for (int e = tid; e < items; e += 2 * nthreads) {
    TileItem<V> a, b;
    load(e, a);
    load(e + nthreads, b);
    store(a);
    if (e + nthreads < items) store(b);
  }
}

// One unit for a block of G crops x R output rows x CB output channels;
// r is the residual (the unit's input for a self-residual unit).  Warps:
// wm (pixels, 32 each: two m16 fragments) x wn (channels, 8*NF each).
// Shared memory: Wu's chunks [wst][CB][WKP], Wd [D][WDP], bd/ad/bu/au
// (f32), the tap table, the output-pixel tables, the inside table, then
// the x tile and the z tile, which the f32 sums [CB][SP] overlay once GEMM2
// is done.  Narrow warp tiles ask for more blocks an SM (fewer registers):
// the phases of one block run one after another, so latency is hidden
// across blocks.
template <int NF>
__global__ void __launch_bounds__(32 * TC_MAX_WARPS,
                                  NF <= 2 ? 4 : NF <= 4 ? 3 : 2)
bottleneck_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ r,
                     const bf16* __restrict__ wd, const float* __restrict__ bd,
                     const float* __restrict__ ad,
                     const bf16* __restrict__ wu, const float* __restrict__ bu,
                     const float* __restrict__ au, bf16* __restrict__ out,
                     int B, int C, int D, int CO, int H, int W, int act,
                     int G, int R, int CB, int wn, int pitch_x, int pitch_z,
                     int SP, int wst) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int CP = (C + 15) / 16 * 16, WDP = CP + 8;
  const int K2 = 9 * D, ks2 = (K2 + 15) / 16, nchunks = (ks2 + 3) / 4;
  const int twp = W + 2, cs = (R + 2) * twp, RW = R * W;
  const int npz = G * cs, npz16 = (npz + 15) / 16 * 16;
  const int P = G * RW;
  bf16* wring = reinterpret_cast<bf16*>(tc_smem);
  bf16* wds = wring + wst * CB * WKP;
  float* bds = reinterpret_cast<float*>(wds + D * WDP);
  float* ads = bds + D;
  float* bus = ads + D;
  float* aus = bus + CB;
  int* kofs = reinterpret_cast<int*>(aus + CB);
  int* opix = kofs + (2 * ks2 + 3) / 4 * 4;
  int* ogl = opix + (P + 3) / 4 * 4;
  unsigned char* inb = reinterpret_cast<unsigned char*>(
      ogl + (P + 3) / 4 * 4);
  bf16* xt = reinterpret_cast<bf16*>(inb + npz16);
  bf16* zt = xt + npz16 * pitch_x;
  float* stg = reinterpret_cast<float*>(xt);   // after GEMM2

  const int n0 = blockIdx.x * CB;
  const int r0 = blockIdx.y * R;
  const int b0 = blockIdx.z * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int wm = nwarps / wn, warp_m = warp % wm, warp_n = warp / wm;
  const uint32_t wring_s = smem_u32(wring), wds_s = smem_u32(wds);
  const uint32_t xt_s = smem_u32(xt), zt_s = smem_u32(zt);

  // Wd [D][C] -> [D][WDP] (channels past C zero) and bd, ad, bu, au
  // (channels past CO and a null au zero): one commit group.
  for (int e = tid; e < D * (CP / 8); e += nthreads) {
    const int d = e / (CP / 8), seg = e - d * (CP / 8);
    const bool ok = seg * 8 < C;
    cp_async16(wds_s + (d * WDP + seg * 8) * 2,
               ok ? wd + (long long)d * C + seg * 8 : wd, ok ? 16 : 0);
  }
  for (int e = tid; e < (D + CB) / 2; e += nthreads) {
    const int f = 4 * e;                  // float of [bd | ad | bu | au]
    const float* src = bd;
    int bytes = 16;
    if (f < D) {
      src = bd + f;
    } else if (f < 2 * D) {
      src = ad + f - D;
    } else {
      const int m = f - 2 * D, co = n0 + (m < CB ? m : m - CB);
      const float* base = m < CB ? bu : au;
      const int left = base == nullptr ? 0 : (CO - co) * 4;
      bytes = left < 0 ? 0 : left < 16 ? left : 16;
      src = bytes > 0 ? base + co : bd;
    }
    cp_async16(smem_u32(bds + f), src, bytes);
  }
  cp_async_commit();
  // Wu chunk c (rows n0.., k c*WKC..) -> ring stage: rows past CO and
  // columns past 9D zero-filled (9D % 8 == 0: a piece is all in or out).
  auto load_w = [&](int c, int stage) {
    const uint32_t dst = wring_s + stage * CB * WKP * 2;
    for (int e = tid; e < CB * (WKC / 8); e += nthreads) {
      const int m = e >> 3, seg = e & 7;
      const int k = c * WKC + seg * 8;
      const bool ok = n0 + m < CO && k < K2;
      cp_async16(dst + (m * WKP + seg * 8) * 2,
                 ok ? wu + (long long)(n0 + m) * K2 + k : wu, ok ? 16 : 0);
    }
  };
  // Two commit groups of Wu: all of it when the plan holds every chunk
  // (`wst` >= nchunks, one wait), else chunks 0 and 1 of a WSTAGES ring.
  const bool all_in = wst >= nchunks;
  if (all_in) {
    for (int c = 0; c < nchunks; ++c) load_w(c, c);
    cp_async_commit();
    cp_async_commit();
  } else {
#pragma unroll
    for (int c = 0; c < WSTAGES - 1; ++c) {
      load_w(c, c);
      cp_async_commit();
    }
  }

  // Output pixel n -> its tile pixel (bit 30 set where it lies past B or
  // H: computed, not stored) and its offset in [B, CO, H, W] from
  // (b0, channel 0, r0, 0).
  const Div d_rw = make_div(RW), d_w = make_div(W), d_cs = make_div(cs),
            d_twp = make_div(twp);
  for (int n = tid; n < P; n += nthreads) {
    const int g = n / d_rw, rem = n - g * RW, ry = rem / d_w;
    const bool ok = b0 + g < B && r0 + ry < H;
    opix[n] = (g * cs + (ry + 1) * twp + (rem - ry * W) + 1) |
              (ok ? 0 : 1 << 30);
    ogl[n] = g * CO * H * W + rem;
  }
  // Tile pixel -> 1 where it lies in the image (z is forced to 0 elsewhere).
  for (int pz = tid; pz < npz; pz += nthreads) {
    const int g = pz / d_cs, rem = pz - g * cs;
    const int yy = rem / d_twp, xx = rem - yy * twp;
    const int iy = r0 - 1 + yy;
    inb[pz] = b0 + g < B && iy >= 0 && iy < H && xx >= 1 && xx <= W;
  }

  // k-group g (8 window rows) -> byte offset of (tap shift, channel) in
  // the z tile.  Groups past 9D meet zero weights and read group 0.
  const int pz_b = pitch_z * 2;
  for (int g = tid; g < 2 * ks2; g += nthreads) {
    const int k = g * 8 < K2 ? g * 8 : 0;
    const int t = k / D, d0 = k - t * D;
    const int shift = (t / 3 - 1) * twp + (t % 3 - 1);
    kofs[g] = shift * pz_b + d0 * 2;
  }

  const int cgroups = CP / 8;
  const int vw = W % 4 == 0 ? 4 : W % 2 == 0 ? 2 : 1;
  if (vw == 4)
    load_x_tile<4>(x, xt, B, C, cgroups, pitch_x, H, W, b0, G, r0, R, tid,
                   nthreads);
  else if (vw == 2)
    load_x_tile<2>(x, xt, B, C, cgroups, pitch_x, H, W, b0, G, r0, R, tid,
                   nthreads);
  else
    load_x_tile<1>(x, xt, B, C, cgroups, pitch_x, H, W, b0, G, r0, R, tid,
                   nthreads);
  // The zero columns left and right of the image.
  const Div d_cgr = make_div(cgroups);
  for (int e = tid; e < G * (R + 2) * 2 * cgroups; e += nthreads) {
    const int gs = e / d_cgr, cg = e - gs * cgroups;
    const int side = gs & 1, row = gs >> 1;      // row: g * (R+2) + yy
    *reinterpret_cast<uint4*>(xt + (row * twp + side * (W + 1)) * pitch_x +
                              cg * 8) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_wait<2>();                    // Wd and the biases are in
  __syncthreads();

  // ldmatrix lane roles.  A x4: row (lane&7) + ((lane>>3)&1)*8 of the m16
  // fragment, k-group lane>>4.  B x4: n-row (lane>>4)*8 + (lane&7) (two n8
  // tiles), k-group (lane>>3)&1; x2 uses lanes 0-15 of the same rule.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_kg = lane >> 4;
  const int b_row = (lane >> 4) * 8 + (lane & 7);
  const int b_kg = (lane >> 3) & 1;

  // -- GEMM1: z[pix, D] = x_tile[pix, C] . Wd^T over the padded region ------
  const int px_b = pitch_x * 2;
  for (int d0 = 0; d0 < D; d0 += 64) {
    const int nd8 = (D - d0) / 8 < 8 ? (D - d0) / 8 : 8;
    for (int mt = warp; mt < npz16 / 16; mt += nwarps) {
      const uint32_t abase = xt_s + (mt * 16 + a_row) * px_b + a_kg * 16;
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
      for (int s = 0; s < CP / 16; ++s) {
        uint32_t a[4];
        ldmatrix_x4(a, abase + s * 32);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          if (2 * p >= nd8) break;
          uint32_t b[4];
          if (2 * p + 1 < nd8) {
            ldmatrix_x4(b, wds_s + ((d0 + p * 16 + b_row) * WDP + s * 16 +
                                    b_kg * 8) * 2);
          } else {
            ldmatrix_x2(b, wds_s + ((d0 + p * 16 + (lane & 7)) * WDP +
                                    s * 16 + b_kg * 8) * 2);
          }
          mma_bf16(acc[2 * p], a, b);
          if (2 * p + 1 < nd8) mma_bf16(acc[2 * p + 1], a, b + 2);
        }
      }
      // Epilogue: + bd, PReLU, zero outside the image (SAME padding of z),
      // rounded to bf16 into the z tile.
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int pz = mt * 16 + (lane >> 2) + hh * 8;
        if (pz >= npz) continue;
        const bool inside = inb[pz];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (nt >= nd8) break;
          const int d = d0 + nt * 8 + (lane & 3) * 2;
          float v0 = 0.0f, v1 = 0.0f;
          if (inside) {
            v0 = acc[nt][hh * 2] + bds[d];
            v1 = acc[nt][hh * 2 + 1] + bds[d + 1];
            v0 = v0 >= 0.0f ? v0 : v0 * ads[d];
            v1 = v1 >= 0.0f ? v1 : v1 * ads[d + 1];
          }
          *reinterpret_cast<uint32_t*>(zt + pz * pitch_z + d) =
              pack_bf16x2(v0, v1);
        }
      }
    }
  }

  // -- GEMM2: y[pix, CB] = sum_t z_tile[pix + shift_t, D] . Wu[CB, tD..]^T --
  // A rows: output pixel n -> its z-tile pixel; slots past P read pixel 0.
  uint32_t abase2[2];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf) {
    const int n = warp_m * 32 + mf * 16 + a_row;
    abase2[mf] = zt_s + (n < P ? opix[n] & 0x3fffffff : twp + 1) * pz_b;
  }
  float acc[2][NF][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
  const int nw0 = warp_n * NF * 8;        // the warp's first channel row
  for (int c = 0; c < nchunks; ++c) {
    if (all_in) {
      if (c == 0) {
        cp_async_wait<0>();
        __syncthreads();
      }
    } else {
      // Chunk c is in; every warp is past chunk c-1, whose stage the chunk
      // WSTAGES-1 ahead now takes.
      cp_async_wait<WSTAGES - 2>();
      __syncthreads();
      if (c + WSTAGES - 1 < nchunks)
        load_w(c + WSTAGES - 1, (c + WSTAGES - 1) % WSTAGES);
      cp_async_commit();
    }
    const uint32_t wb = wring_s + (all_in ? c : c % WSTAGES) * CB * WKP * 2;
#pragma unroll
    for (int s = 0; s < WKC / 16; ++s) {
      const int j = c * (WKC / 16) + s;
      if (j < ks2) {
        const int ko = kofs[2 * j + a_kg];
        uint32_t a[2][4];
        ldmatrix_x4(a[0], abase2[0] + ko);
        ldmatrix_x4(a[1], abase2[1] + ko);
#pragma unroll
        for (int p = 0; p < (NF + 1) / 2; ++p) {
          uint32_t b[4];
          if (2 * p + 1 < NF) {
            ldmatrix_x4(b, wb + ((nw0 + p * 16 + b_row) * WKP + s * 16 +
                                 b_kg * 8) * 2);
          } else {
            ldmatrix_x2(b, wb + ((nw0 + p * 16 + (lane & 7)) * WKP +
                                 s * 16 + b_kg * 8) * 2);
          }
#pragma unroll
          for (int mf = 0; mf < 2; ++mf) {
            mma_bf16(acc[mf][2 * p], a[mf], b);
            if (2 * p + 1 < NF) mma_bf16(acc[mf][2 * p + 1], a[mf], b + 2);
          }
        }
      }
    }
  }

  // -- Epilogue ---------------------------------------------------------------
  // The raw f32 sums go to [CB][SP] over the x tile; then one loop over
  // (channel, pixel pair) adds bu and the residual r (from device memory; a
  // unit's own input was read moments ago and is in L2), applies the
  // activation, rounds once and stores, neighbouring threads on
  // neighbouring pixels.
  __syncthreads();                      // every warp is past GEMM2
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = warp_m * 32 + mf * 16 + (lane >> 2) + hh * 8;
      if (m >= P) continue;
#pragma unroll
      for (int nt = 0; nt < NF; ++nt) {
        const int cl = nw0 + nt * 8 + (lane & 3) * 2;
        stg[cl * SP + m] = acc[mf][nt][hh * 2];
        stg[(cl + 1) * SP + m] = acc[mf][nt][hh * 2 + 1];
      }
    }
  __syncthreads();
  const long long hw = (long long)H * W;
  const long long base = (long long)b0 * CO * hw + (long long)r0 * W;
  const int nco = CO - n0 < CB ? CO - n0 : CB;
  auto finish = [&](float v, int cl) {
    if (act == 2) return v >= 0.0f ? v : v * aus[cl];
    if (act == 1) return fmaxf(v, 0.0f);
    return v;
  };
  if ((W & 1) == 0) {                   // pixel pairs: 4-byte loads, stores
    const int np2 = P >> 1;
    const Div d_np2 = make_div(np2);
    for (int e = tid; e < nco * np2; e += nthreads) {
      const int cl = e / d_np2, n = 2 * (e - cl * np2);
      if (opix[n] >> 30) continue;
      const long long gi = base + ogl[n] + (long long)(n0 + cl) * hw;
      const __nv_bfloat162 rv =
          *reinterpret_cast<const __nv_bfloat162*>(r + gi);
      const float bb = bus[cl];
      const float v0 = finish(stg[cl * SP + n] + bb + __low2float(rv), cl);
      const float v1 =
          finish(stg[cl * SP + n + 1] + bb + __high2float(rv), cl);
      *reinterpret_cast<uint32_t*>(out + gi) = pack_bf16x2(v0, v1);
    }
  } else {
    const Div d_p = make_div(P);
    for (int e = tid; e < nco * P; e += nthreads) {
      const int cl = e / d_p, n = e - cl * P;
      if (opix[n] >> 30) continue;
      const long long gi = base + ogl[n] + (long long)(n0 + cl) * hw;
      const float v = stg[cl * SP + n] + bus[cl] + __bfloat162float(r[gi]);
      out[gi] = __float2bfloat16_rn(finish(v, cl));
    }
  }
}

// -- launch plan (the rule of kernels/bottleneck.py `bottleneck_plan`) -----

struct TcPlan {
  int g, rows, groups, bands, nsplit, cb, wn, nf, wm, pitch_x, pitch_z, sp,
      wst, smem;
};

static int cdiv(int a, int b) { return (a + b - 1) / b; }

static int odd_units(int n8) { return 8 * (n8 % 2 == 0 ? n8 + 1 : n8); }

// 0 on success; 1 for a shape the kernel does not take (C or D not a
// multiple of 8, rows wider than 256 pixels, or no plan in shared memory).
static int make_tc_plan(int b, int h, int w, int c, int d, int co,
                        TcPlan* p) {
  if (c < 8 || c % 8 || d < 8 || d % 8 || co < 1 || h < 1 || w < 1 ||
      w > TC_PIXELS || b < 1)
    return 1;
  const int cp = cdiv(c, 16) * 16;
  const int pitch_x = odd_units(cp / 8), pitch_z = odd_units(d / 8);
  const int nct = cdiv(co, 8);
  int g, rows;
  if (h * w >= TC_PIXELS) {
    g = 1;
    rows = TC_PIXELS / w < h ? TC_PIXELS / w : h;
  } else {
    g = TC_PIXELS / (h * w) < b ? TC_PIXELS / (h * w) : b;
    rows = h;
  }
  int nsplit = 1;
  auto shrink = [&]() {
    if (g > 1) { g = cdiv(g, 2); return true; }
    if (rows > 1) { rows = cdiv(rows, 2); return true; }
    return false;
  };
  auto fill = [&](TcPlan* q) {
    const int ntb = cdiv(nct, nsplit);
    const int pix = g * rows * w;
    q->wm = cdiv(pix, 32);
    // 8 warps a block where the channels allow: few pixels take more
    // channel warps.
    const int wn8 = cdiv(TC_MAX_WARPS, q->wm) < ntb ? cdiv(TC_MAX_WARPS, q->wm)
                                                   : ntb;
    q->wn = cdiv(ntb, 8) > wn8 ? cdiv(ntb, 8) : wn8;
    q->nf = cdiv(ntb, q->wn);
    q->cb = 8 * q->wn * q->nf;
    q->nsplit = cdiv(co, q->cb);
    q->pitch_x = pitch_x;
    q->pitch_z = pitch_z;
    q->g = g;
    q->rows = rows;
    q->groups = cdiv(b, g);
    q->bands = cdiv(h, rows);
    q->sp = cdiv(pix, 16) * 16 + 4;
    const int npz16 = cdiv(g * (rows + 2) * (w + 2), 16) * 16;
    const int tiles = npz16 * (pitch_x + pitch_z) * 2;
    const int stage = q->cb * q->sp * 4;
    const int ks2 = cdiv(9 * d, 16), nchunks = cdiv(ks2, 4);
    const int rest = d * (cp + 8) * 2 + (2 * d + 2 * q->cb) * 4 +
                     cdiv(2 * ks2, 4) * 16 + 2 * cdiv(pix, 4) * 16 + npz16 +
                     (tiles > stage ? tiles : stage);
    // All of Wu's chunks where they fit, else a ring of WSTAGES.
    const int chunk = q->cb * WKP * 2;
    q->wst = nchunks;
    if (nchunks > WSTAGES && rest + nchunks * chunk > TC_SMEM_BUDGET)
      q->wst = WSTAGES;
    q->smem = rest + q->wst * chunk;
  };
  TcPlan q;
  // Fit a block (at most 8 warps, two blocks an SM), then fill the card
  // (two blocks an SM): split the channels across blocks first (each
  // split recomputes z: a tenth of a unit's products when C' = C),
  // then take fewer pixels a block.
  for (;;) {
    fill(&q);
    if (q.wm * q.wn > TC_MAX_WARPS || q.smem > TC_SMEM_BUDGET) {
      if (q.cb > 32) {
        nsplit *= 2;
      } else if (!shrink()) {
        return 1;
      }
    } else if (q.nsplit * q.groups * q.bands < TC_TARGET_BLOCKS) {
      if (q.cb > 32) {
        nsplit *= 2;
      } else if (!(g * rows * w > TC_MIN_PIXELS && shrink())) {
        break;
      }
    } else {
      break;
    }
  }
  *p = q;
  return p->smem <= MAX_SMEM ? 0 : 1;
}

template <int NF>
static int tc_unit(const TcPlan& p, const bf16* x, const bf16* r,
                   const bf16* wd, const float* bd, const float* ad,
                   const bf16* wu, const float* bu, const float* au,
                   bf16* out, int B, int C, int D, int CO, int H, int W,
                   int act, cudaStream_t st) {
  auto kern = bottleneck_tc_kernel<NF>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  dim3 grid(p.nsplit, p.bands, p.groups);
  kern<<<grid, 32 * p.wm * p.wn, p.smem, st>>>(
      x, r, wd, bd, ad, wu, bu, au, out, B, C, D, CO, H, W, act, p.g,
      p.rows, p.cb, p.wn, p.pitch_x, p.pitch_z, p.sp, p.wst);
  return (int)cudaGetLastError();
}

// U units, one launch each, ping-ponging between `buf` and `out` so that
// the last lands in `out`.  A null r: each unit's residual is its input.
static int tc_launch(const void* x, const void* r, const void* wd,
                     const void* bd, const void* ad, const void* wu,
                     const void* bu, const void* au, void* out, void* buf,
                     int B, int U, int C, int D, int CO, int H, int W,
                     int act, cudaStream_t st) {
  TcPlan p;
  if (make_tc_plan(B, H, W, C, D, CO, &p) || (U > 1 && buf == nullptr))
    return (int)cudaErrorInvalidValue;
  const bf16* in = (const bf16*)x;
  for (int u = 0; u < U; ++u) {
    bf16* dst = (bf16*)(((U - 1 - u) & 1) ? buf : out);
    const bf16* wdu = (const bf16*)wd + (long long)u * D * C;
    const bf16* wuu = (const bf16*)wu + (long long)u * CO * 9 * D;
    const float* bdu = (const float*)bd + u * D;
    const float* adu = (const float*)ad + u * D;
    const float* buu = (const float*)bu + u * CO;
    const float* auu = au == nullptr ? nullptr : (const float*)au + u * CO;
    int err = (int)cudaErrorInvalidValue;
#define TC_CASE(NF_)                                                        \
  case NF_:                                                                 \
    err = tc_unit<NF_>(p, in, r ? (const bf16*)r : in, wdu, bdu, adu, wuu,  \
                       buu, auu, dst, B, C, D, CO, H, W, act, st);          \
    break;
    switch (p.nf) {
      TC_CASE(1) TC_CASE(2) TC_CASE(3) TC_CASE(4)
      TC_CASE(5) TC_CASE(6) TC_CASE(7) TC_CASE(8)
    }
#undef TC_CASE
    if (err) return err;
    in = dst;
  }
  return 0;
}

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// The launch plan of a shape, for the wrapper to hold against
// its own: out[14] = g, rows, groups, bands, nsplit, cb, wn, nf, wm,
// pitch_x, pitch_z, sp, wst, smem.
int bottleneck_plan(int b, int h, int w, int c, int d, int co, int* out) {
  TcPlan p;
  const int err = make_tc_plan(b, h, w, c, d, co, &p);
  const int v[14] = {p.g,       p.rows,    p.groups, p.bands, p.nsplit,
                     p.cb,      p.wn,      p.nf,     p.wm,    p.pitch_x,
                     p.pitch_z, p.sp,      p.wst,    p.smem};
  for (int i = 0; i < 14; ++i) out[i] = err ? 0 : v[i];
  return err;
}

// K5.  x: [B, C, H, W], r and out: [B, CO, H, W], bf16; wd: [D, C], wu:
// [CO, 9D], bf16; bd/ad: f32 [D]; bu/au: f32 [CO] (au may be null unless
// act == 2); act: 0 none, 1 relu, 2 prelu.
int bottleneck_s1_launch(const void* x, const void* r, const void* wd,
                         const void* bd, const void* ad, const void* wu,
                         const void* bu, const void* au, void* out, int B,
                         int C, int D, int CO, int H, int Wd, int act,
                         void* stream) {
  return tc_launch(x, r, wd, bd, ad, wu, bu, au, out, nullptr, B, 1, C, D,
                   CO, H, Wd, act, (cudaStream_t)stream);
}

// K6.  x and out: [B, C, H, W], bf16; wd: [U, D, C], wu: [U, C, 9D], bf16;
// bd/ad: f32 [U, D]; bu/au: f32 [U, C].  U launches, ping-ponging through
// `buf` ([B, C, H, W], bf16), which U > 1 needs.
int bottleneck_chain_launch(const void* x, const void* wd, const void* bd,
                            const void* ad, const void* wu, const void* bu,
                            const void* au, void* buf, void* out, int B,
                            int U, int C, int D, int H, int Wd, int act,
                            void* stream) {
  return tc_launch(x, nullptr, wd, bd, ad, wu, bu, au, out, buf, B, U, C, D,
                   C, H, Wd, act, (cudaStream_t)stream);
}

}  // extern "C"
