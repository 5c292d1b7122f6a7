// K8: PhysFormer's clip standardisation -- each clip the net runs on read in
// place from the engine's ring of face crops, its mean and population
// variance in f32, and (x - mean) / std written once as a fresh contiguous
// bf16 clip, the net's input.
//
// Replaces no TPU kernel: the JAX package has no PhysFormer.  It replaces
// the composition `runtime/engine.py` ran before the net: a gather of the
// due clips out of the ring by advanced indexing, then, eight clips at a
// time, a cast to f32, a mean, a subtraction, a square, a second mean, a
// product and a copy back to bf16.  At 64 clips of 160 frames of 128x128
// that moved about 24 GB a call.
//
// What it computes.  The ring is crops bf16 [S, T + 1, F] (F = C*C*3, the
// values of one crop; slot T is a spare that takes unpushed crops and is
// never read here) with head int64 [S]: slot (head + t) % T holds the
// stream's t-th oldest crop.  rows int64 [B] names the stream of each clip
// (none: clip b is stream b).  For clip b of stream r = rows[b], over its
// n = T*F values x:
//   mean = sum(x) / n,  var = sum((x - mean)^2) / n  (the centred moment),
//   out[b, t, :] = (crops[r, (head[r] + t) % T, :] - mean) * rsqrt(var),
//                  or 0 where var == 0,
// in f32, rounded once to bf16 (round to nearest even).
//
// Bound on this card (NVIDIA H100): bytes.  Each clip is read twice (the
// statistics, then the output) and written once: 3 x 2 B x B*T*F, 3.0 GB
// at 64 clips of 160 frames of 128x128, 0.90 ms at 3.35 TB/s.  The design
// moves nothing else:
//
// - clip_stats_kernel: B x P blocks, P from the occupancy so that the
//   grid fills every SM once.  Block p reads the p-th part of a clip's T
//   slots as they lie in the ring (the statistics do not depend on the
//   frames' order), 16 bytes a load, four loads in flight a thread.  Each
//   group of loads gives its own (n, mean, M2) from registers (the mean,
//   then the centred squares), merged into the thread's by Chan's rule;
//   the warp, then the block merge the threads' in a fixed tree, and the
//   block writes its (mean, M2).  No atomics: the same ring gives the same
//   bits.
// - clip_apply_kernel: B x Q blocks.  Each merges its clip's P parts in a
//   fixed order (every block of a clip gets the same bits), then writes
//   its Q-th of the clip, each 16-byte piece read from slot (head + t) % T.
//
// A frame whose F is not a multiple of 8, or a ring not 16-byte aligned,
// takes the same kernels one value a load (VEC = 1).
//
// Exports only the extern "C" entries at the end; everything else has
// internal linkage.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;  // loads in flight a thread
static_assert(UNROLL == 4, "clip_stats_kernel adds its four group sums");

// The first of `n` pieces in part `p` of `parts` (parts as even as can be).
__device__ __forceinline__ int part_begin(int n, int p, int parts) {
  return (int)((long long)n * p / parts);
}

// (na, ma, qa) <- the count, mean and centred second moment of the values
// of a and b together (Chan, Golub and LeVeque's pairwise rule).  An empty
// side (count 0) leaves the other as it is.
__device__ __forceinline__ void merge(int& na, float& ma, float& qa, int nb,
                                      float mb, float qb) {
  const int n = na + nb;
  const float f = n > 0 ? (float)nb / (float)n : 0.f;
  const float d = mb - ma;
  ma = fmaf(d, f, ma);
  qa = qa + qb + d * d * (float)na * f;
  na = n;
}

// Lane 0 gets the warp's merge, in a fixed tree.
__device__ __forceinline__ void warp_merge(int& n, float& m, float& q) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int nb = __shfl_down_sync(0xffffffffu, n, off);
    const float mb = __shfl_down_sync(0xffffffffu, m, off);
    const float qb = __shfl_down_sync(0xffffffffu, q, off);
    merge(n, m, q, nb, mb, qb);
  }
}

// Thread 0 gets the block's merge, in a fixed tree.
__device__ __forceinline__ void block_merge(int& n, float& m, float& q) {
  __shared__ int s_n[WARPS];
  __shared__ float s_m[WARPS], s_q[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_merge(n, m, q);
  if (lane == 0) {
    s_n[warp] = n;
    s_m[warp] = m;
    s_q[warp] = q;
  }
  __syncthreads();
  if (warp == 0) {
    n = lane < WARPS ? s_n[lane] : 0;
    m = lane < WARPS ? s_m[lane] : 0.f;
    q = lane < WARPS ? s_q[lane] : 0.f;
    warp_merge(n, m, q);
  }
}

// VEC values from p (16 bytes when VEC is 8) as f32, exactly.
template <int VEC>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
  if constexpr (VEC == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    v[0] = __bfloat162float(*p);
  }
}

// VEC f32 values rounded to bf16 (nearest even) into p.
template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
  if constexpr (VEC == 8) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
    clip_stats_kernel(const __nv_bfloat16* __restrict__ crops,
                      const long long* __restrict__ rows,
                      float2* __restrict__ parts, int t_len, int frame) {
  const int b = blockIdx.y, p = blockIdx.x, nparts = gridDim.x;
  const long long row = rows ? rows[b] : b;
  const __nv_bfloat16* clip = crops + (size_t)row * (t_len + 1) * frame;
  const int nvec = t_len * frame / VEC;
  const int v1 = part_begin(nvec, p + 1, nparts);
  int n = 0;
  float mean = 0.f, m2 = 0.f;
  for (int v = part_begin(nvec, p, nparts) + threadIdx.x; v < v1;
       v += THREADS * UNROLL) {
    float x[UNROLL][VEC];
    int k = 0;  // the loads that lie in the part: a prefix of the UNROLL
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (v + u * THREADS < v1) {
        load<VEC>(clip + (size_t)(v + u * THREADS) * VEC, x[u]);
        k = u + 1;
      }
    float s[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      s[u] = 0.f;
      if (u < k)
#pragma unroll
        for (int i = 0; i < VEC; ++i) s[u] += x[u][i];
    }
    const int cn = k * VEC;
    const float cm = ((s[0] + s[1]) + (s[2] + s[3])) / (float)cn;
    float cq = 0.f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (u < k)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float d = x[u][i] - cm;
          cq = fmaf(d, d, cq);
        }
    merge(n, mean, m2, cn, cm, cq);
  }
  block_merge(n, mean, m2);
  if (threadIdx.x == 0) parts[(size_t)b * nparts + p] = make_float2(mean, m2);
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
    clip_apply_kernel(const __nv_bfloat16* __restrict__ crops,
                      const long long* __restrict__ head,
                      const long long* __restrict__ rows,
                      const float2* __restrict__ parts,
                      __nv_bfloat16* __restrict__ out, int t_len, int frame,
                      int nparts) {
  const int b = blockIdx.y, q = blockIdx.x, napply = gridDim.x;
  const long long row = rows ? rows[b] : b;
  const int nvec = t_len * frame / VEC;
  // The clip's statistics: its parts merged in a fixed order.
  int n = 0;
  float mean = 0.f, m2 = 0.f;
  for (int p = threadIdx.x; p < nparts; p += THREADS) {
    const float2 pm = parts[(size_t)b * nparts + p];
    const int pn = (part_begin(nvec, p + 1, nparts) -
                    part_begin(nvec, p, nparts)) * VEC;
    merge(n, mean, m2, pn, pm.x, pm.y);
  }
  block_merge(n, mean, m2);
  __shared__ float s_mean, s_scale;
  __shared__ int s_head;
  if (threadIdx.x == 0) {
    const float var = m2 / (float)n;
    s_mean = mean;
    s_scale = var > 0.f ? rsqrtf(var) : 0.f;
    s_head = (int)(((head[row] % t_len) + t_len) % t_len);
  }
  __syncthreads();
  const float mu = s_mean, scale = s_scale;
  const int h = s_head, vpf = frame / VEC;  // vectors a frame
  const __nv_bfloat16* ring = crops + (size_t)row * (t_len + 1) * frame;
  __nv_bfloat16* dst = out + (size_t)b * t_len * frame;
  const int v1 = part_begin(nvec, q + 1, napply);
  int v = part_begin(nvec, q, napply) + threadIdx.x;
  int t = v / vpf, off = v - t * vpf;  // output frame, vector in it
  for (; v < v1; v += THREADS * UNROLL) {
    float x[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (v + u * THREADS < v1) {
        const int slot = h + t < t_len ? h + t : h + t - t_len;
        load<VEC>(ring + ((size_t)slot * vpf + off) * VEC, x[u]);
      }
      off += THREADS;
      while (off >= vpf) {
        off -= vpf;
        ++t;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (v + u * THREADS < v1) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) x[u][i] = (x[u][i] - mu) * scale;
        store<VEC>(dst + (size_t)(v + u * THREADS) * VEC, x[u]);
      }
  }
}

// Blocks a clip for a kernel: as many as fill every SM once over `b`
// clips, at least one, and no more than give each thread a full group of
// loads.
template <class K>
int parts_for(K kern, int b, int nvec) {
  int dev = 0, sms = 0, occ = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, THREADS, 0);
  int p = sms * (occ > 0 ? occ : 1) / b;
  const int most = nvec / (THREADS * UNROLL);
  if (p > most) p = most;
  return p > 0 ? p : 1;
}

bool bad_shape(int b, int t_len, int frame, int vec) {
  return b < 1 || b > 65535 || t_len < 1 || frame < 1 ||
         (vec != 1 && vec != 8) || frame % vec != 0 ||
         (long long)t_len * frame > (1LL << 30);
}

}  // namespace

extern "C" {

const char* kernel_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// The grid of each launch for b clips of t_len frames of `frame` values
// read `vec` at a time: parts[0] blocks a clip for the statistics,
// parts[1] for the output.
int clip_standardise_plan(int b, int t_len, int frame, int vec, int* parts) {
  if (bad_shape(b, t_len, frame, vec)) return (int)cudaErrorInvalidValue;
  const int nvec = t_len * frame / vec;
  if (vec == 8) {
    parts[0] = parts_for(clip_stats_kernel<8>, b, nvec);
    parts[1] = parts_for(clip_apply_kernel<8>, b, nvec);
  } else {
    parts[0] = parts_for(clip_stats_kernel<1>, b, nvec);
    parts[1] = parts_for(clip_apply_kernel<1>, b, nvec);
  }
  return (int)cudaGetLastError();
}

// crops: bf16 [S, t_len + 1, frame]; rows: int64 [b] or null (clip i is
// stream i); parts: f32 [b, nparts, 2], written.
int clip_stats_launch(const void* crops, const void* rows, void* parts, int b,
                      int t_len, int frame, int vec, int nparts,
                      void* stream) {
  if (bad_shape(b, t_len, frame, vec) || nparts < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nparts, b);
  cudaStream_t st = (cudaStream_t)stream;
  const auto* x = (const __nv_bfloat16*)crops;
  const auto* r = (const long long*)rows;
  if (vec == 8)
    clip_stats_kernel<8><<<grid, THREADS, 0, st>>>(x, r, (float2*)parts,
                                                   t_len, frame);
  else
    clip_stats_kernel<1><<<grid, THREADS, 0, st>>>(x, r, (float2*)parts,
                                                   t_len, frame);
  return (int)cudaGetLastError();
}

// head: int64 [S]; parts: clip_stats_launch's, of nparts a clip; out: bf16
// [b, t_len, frame], written.
int clip_apply_launch(const void* crops, const void* head, const void* rows,
                      const void* parts, void* out, int b, int t_len,
                      int frame, int vec, int nparts, int napply,
                      void* stream) {
  if (bad_shape(b, t_len, frame, vec) || nparts < 1 || napply < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(napply, b);
  cudaStream_t st = (cudaStream_t)stream;
  const auto* x = (const __nv_bfloat16*)crops;
  const auto* h = (const long long*)head;
  const auto* r = (const long long*)rows;
  const auto* pp = (const float2*)parts;
  auto* o = (__nv_bfloat16*)out;
  if (vec == 8)
    clip_apply_kernel<8><<<grid, THREADS, 0, st>>>(x, h, r, pp, o, t_len,
                                                   frame, nparts);
  else
    clip_apply_kernel<1><<<grid, THREADS, 0, st>>>(x, h, r, pp, o, t_len,
                                                   frame, nparts);
  return (int)cudaGetLastError();
}

}  // extern "C"
