// Polar group encode of post-RoPE keys (replaces the Pallas kernel
// repro/kernels/polar_encode.py::polar_encode).
//
// For each group (g tokens of one kv head and row) it computes
// rho = sqrt(x^2 + y^2) and theta = atan2(y, x) + pi over the "half" pairs
// (x = k[:, p], y = k[:, p + P]), the per-pair min/max over the g tokens,
// and the mid-rise codes floor((v - min) / s), s = max((max - min) /
// 2^bits, 1e-8), packed as (rho_code << t) | theta_code, plus the four
// stat rows.
//
// One pass over a thread block cluster: the g tokens of a group are split
// across the kCluster blocks of one cluster (grid (G * kCluster, H, B)).
// A thread owns kVec = 4 adjacent pairs of a token (one vector load of the
// x half and one of the y half: 8 bytes in bf16, 16 in fp32) for up to J
// tokens, computes rho and theta once and keeps them in registers; the
// block reduces its tokens' per-pair min/max in shared memory, the cluster
// combines the blocks' rows through distributed shared memory (every block
// reads its peers' rows after a cluster barrier), and each block writes its
// tokens' codes from the registers. min and max are exact in any order, so
// the codes and stats are the plain version's bit for bit. Shapes whose
// rows do not split into aligned runs of kVec pairs (P % kVec != 0,
// unaligned keys or codes) run the same body one pair a thread.
//
// The chain of one thread (kVec atan2f, sqrt and two IEEE divisions per
// pair) sets the time once the loads are in: 4 pairs a thread at 256
// threads a block measured 1.2x faster than 8 pairs at 128, and a cluster
// of 4 1.5x faster than one block per group (chip_smoke.py --variants).
//
// With `pages` given, group (b, n) goes to pool page pages[b * G + n] —
// the JAX encode-then-scatter fused into one launch; a negative page id
// skips the group (decode steps re-encode every slot's residual but only
// flushing slots write). All blocks of a cluster share one group, so they
// skip it together, before any cluster barrier.
//
// With `fixed` set (the fixed angle grid, QuantConfig(theta_stats="fixed"))
// theta has the known support (0, 2pi]: the block and cluster reductions
// cover only the two rho rows, theta_scale is the constant `tstep` = 2pi /
// 2^t (rounded to float32 by the caller), theta_zero is 0, and the angle
// code is floor(theta / tstep) clipped to 2^t - 1 — the mid-rise code with
// a zero of 0, so the same code_of, bit for bit (theta == 2pi gives 2^t
// exactly and clips to the top code).
//
// Bound: bytes. Per group it reads g*d key elements and writes g*P code
// bytes + 4*P stats; the arithmetic (one sqrt and one atan2 per pair) is
// small next to that. A group is one short dependent chain (load, polar
// transform, reduction, codes), so the time follows how many chains run
// side by side: the cluster puts kCluster SMs on each group (the
// 1024-token prefill form runs 128 blocks instead of 32).
#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 4;        // blocks per group
constexpr int kVec = 4;            // pairs a thread owns in the wide body
constexpr int kWideThreads = 256;  // block size cap of the wide body
constexpr int kNarrowThreads = 1024;  // of the one-pair-a-thread body
constexpr float kTiny = 1.1754944e-38f;  // smallest normal float32
constexpr float kEps = 1e-8f;

__device__ __forceinline__ void to_polar(float x, float y, float& rho, float& theta) {
  // flush denormals (and -0.0) to +0 before atan2, as the plain version does
  x = fabsf(x) < kTiny ? 0.0f : x;
  y = fabsf(y) < kTiny ? 0.0f : y;
  // explicit round-to-nearest ops: no FMA contraction, so rho matches
  // torch.sqrt(x * x + y * y) bit for bit
  rho = __fsqrt_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)));
  theta = rho > 0.0f ? __fadd_rn(atan2f(y, x), rt::kPi) : rt::kPi;
}

__device__ __forceinline__ unsigned code_of(float v, float mn, float s, float top) {
  const float q = floorf(__fdiv_rn(__fsub_rn(v, mn), s));
  return static_cast<unsigned>(fminf(fmaxf(q, 0.0f), top));
}

// A type of N bytes (1, 2, 4, 8 or 16) for vector accesses
template <int N>
using Word = std::conditional_t<
    N == 16, uint4,
    std::conditional_t<N == 8, uint2,
                       std::conditional_t<N == 4, unsigned,
                                          std::conditional_t<N == 2, unsigned short,
                                                             unsigned char>>>>;

// V adjacent elements at src as floats, in loads of up to 16 bytes
template <typename T, int V>
__device__ __forceinline__ void load_run(const T* __restrict__ src, float* out) {
  if constexpr (V == 1) {
    out[0] = rt::to_f32(*src);
  } else {
    constexpr int kBytes = V * sizeof(T) < 16 ? V * sizeof(T) : 16;
    constexpr int kPer = kBytes / sizeof(T);
#pragma unroll
    for (int w = 0; w < V / kPer; ++w) {
      const auto raw = *reinterpret_cast<const Word<kBytes>*>(src + w * kPer);
      const auto* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kPer; ++i) out[w * kPer + i] = rt::to_f32(e[i]);
    }
  }
}

// Dynamic shared memory: the block's per-pair (rho min, rho max, theta
// min, theta max) rows part (4, P), which the cluster's peers read, then
// the per-slot rows red (4, slots, P) that reduce into it.
template <typename T, int V, int J>
__global__ void __launch_bounds__(V == 1 ? kNarrowThreads : kWideThreads)
    __cluster_dims__(kCluster, 1, 1) polar_encode_kernel(
        const T* __restrict__ k, long long sb, long long sh, long long sn, long long st,
        int H, int G, int g, int P, const int* __restrict__ pages,
        unsigned char* __restrict__ codes, float* __restrict__ rs, float* __restrict__ rz,
        float* __restrict__ ts, float* __restrict__ tz, int r_bits, int t_bits, int fixed,
        float tstep) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = blockIdx.x / kCluster, h = blockIdx.y, b = blockIdx.z;
  long long o;  // output group index: (b, h, n) dense, or (page, h) paged
  if (pages != nullptr) {
    const int page = pages[static_cast<long long>(b) * G + n];
    if (page < 0) return;  // the whole cluster returns: same group
    o = static_cast<long long>(page) * H + h;
  } else {
    o = (static_cast<long long>(b) * H + h) * G + n;
  }
  const T* kt = k + b * sb + h * sh + n * sn;

  const int L = P / V;               // threads per token
  const int slots = blockDim.x / L;  // tokens of one pass
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid % L, slot = tid / L, p0 = lane * V;
  const bool active = slot < slots;
  const int per = (g + kCluster - 1) / kCluster;  // tokens of one block
  const int t_lo = rank * per, t_hi = min(g, t_lo + per);
  float* part = smem;
  float* red = smem + 4 * P;
  const int rows = fixed ? 2 : 4;  // reduced stat rows: rho, then theta

  // every token's pairs loaded (all loads in flight), then rho and theta
  // in place, kept for the code write
  float rho[J][V], th[J][V];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int t = t_lo + slot + j * slots;
    if (active && t < t_hi) {
      load_run<T, V>(kt + t * st + p0, rho[j]);
      load_run<T, V>(kt + t * st + P + p0, th[j]);
    }
  }
  float mn_r[V], mx_r[V], mn_t[V], mx_t[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    mn_r[v] = INFINITY;
    mx_r[v] = -INFINITY;
    mn_t[v] = INFINITY;
    mx_t[v] = -INFINITY;
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int t = t_lo + slot + j * slots;
    if (active && t < t_hi) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        to_polar(rho[j][v], th[j][v], rho[j][v], th[j][v]);
        mn_r[v] = fminf(mn_r[v], rho[j][v]);
        mx_r[v] = fmaxf(mx_r[v], rho[j][v]);
        if (!fixed) {
          mn_t[v] = fminf(mn_t[v], th[j][v]);
          mx_t[v] = fmaxf(mx_t[v], th[j][v]);
        }
      }
    }
  }
  if (active) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      red[(0 * slots + slot) * P + p0 + v] = mn_r[v];
      red[(1 * slots + slot) * P + p0 + v] = mx_r[v];
      if (!fixed) {
        red[(2 * slots + slot) * P + p0 + v] = mn_t[v];
        red[(3 * slots + slot) * P + p0 + v] = mx_t[v];
      }
    }
  }
  __syncthreads();
  // rows w = 0..rows-1 (rho min, rho max, theta min, theta max): even
  // rows take the min, odd rows the max
  for (int i = tid; i < rows * P; i += nthr) {
    const int w = i / P, p = i % P;
    float x = red[w * slots * P + p];
    for (int s = 1; s < slots; ++s) {
      const float y = red[(w * slots + s) * P + p];
      x = w % 2 ? fmaxf(x, y) : fminf(x, y);
    }
    part[i] = x;
  }
  // every block's rows are complete and visible to the cluster
  cluster.sync();
  // the group's min/max: every peer's rows through distributed shared
  // memory, into this block's red (its own reads are done)
  for (int i = tid; i < rows * P; i += nthr) {
    const int w = i / P;
    float x = part[i];
    for (int q = 1; q < kCluster; ++q) {
      const float y = cluster.map_shared_rank(part, (rank + q) % kCluster)[i];
      x = w % 2 ? fmaxf(x, y) : fminf(x, y);
    }
    red[i] = x;
  }
  __syncthreads();
  const float rtop = static_cast<float>((1 << r_bits) - 1);
  const float ttop = static_cast<float>((1 << t_bits) - 1);
  const float rden = static_cast<float>(1 << r_bits), tden = static_cast<float>(1 << t_bits);
  if (rank == 0) {
    for (int p = tid; p < P; p += nthr) {
      rs[o * P + p] = fmaxf(__fdiv_rn(__fsub_rn(red[P + p], red[p]), rden), kEps);
      rz[o * P + p] = red[p];
      ts[o * P + p] =
          fixed ? tstep : fmaxf(__fdiv_rn(__fsub_rn(red[3 * P + p], red[2 * P + p]), tden), kEps);
      tz[o * P + p] = fixed ? 0.0f : red[2 * P + p];
    }
  }
  if (active) {
    float rmn[V], rsc[V], tmn[V], tsc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int p = p0 + v;
      rmn[v] = red[p];
      rsc[v] = fmaxf(__fdiv_rn(__fsub_rn(red[P + p], rmn[v]), rden), kEps);
      tmn[v] = fixed ? 0.0f : red[2 * P + p];
      tsc[v] = fixed ? tstep : fmaxf(__fdiv_rn(__fsub_rn(red[3 * P + p], tmn[v]), tden), kEps);
    }
    unsigned char* ct = codes + o * g * P;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int t = t_lo + slot + j * slots;
      if (t < t_hi) {
        Word<V> word;  // the V code bytes, one store
        auto* wb = reinterpret_cast<unsigned char*>(&word);
#pragma unroll
        for (int v = 0; v < V; ++v)
          wb[v] = static_cast<unsigned char>(
              (code_of(rho[j][v], rmn[v], rsc[v], rtop) << t_bits) |
              code_of(th[j][v], tmn[v], tsc[v], ttop));
        *reinterpret_cast<Word<V>*>(ct + t * P + p0) = word;
      }
    }
  }
  // no block leaves while a peer may still read its rows
  cluster.sync();
}

template <typename T, int V, int J>
int launch(const T* k, long long sb, long long sh, long long sn, long long st, int B, int H,
           int G, int g, int P, const int* pages, unsigned char* codes, float* rs, float* rz,
           float* ts, float* tz, int r_bits, int t_bits, int fixed, float tstep, int threads,
           cudaStream_t s) {
  const int slots = threads / (P / V);
  const size_t smem = sizeof(float) * 4 * static_cast<size_t>(P) * (1 + slots);
  cudaError_t err = rt::allow_smem(polar_encode_kernel<T, V, J>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(G * kCluster, H, B);
  polar_encode_kernel<T, V, J><<<grid, threads, smem, s>>>(k, sb, sh, sn, st, H, G, g, P,
                                                           pages, codes, rs, rz, ts, tz,
                                                           r_bits, t_bits, fixed, tstep);
  return static_cast<int>(cudaGetLastError());
}

// The body for keys of type T, V pairs a thread: the fewest tokens a
// thread (J in 1, 2, 4, 8) at up to `cap` threads a block.
template <typename T, int V>
int launch_body(const T* k, long long sb, long long sh, long long sn, long long st, int B,
                int H, int G, int g, int P, const int* pages, unsigned char* codes, float* rs,
                float* rz, float* ts, float* tz, int r_bits, int t_bits, int fixed,
                float tstep, int cap, cudaStream_t s) {
  const int L = P / V;
  const int per = (g + kCluster - 1) / kCluster;
  const int threads = ((per * L < cap ? per * L : cap) + 31) / 32 * 32;
  if (L > threads) return static_cast<int>(cudaErrorInvalidValue);
  const int slots = threads / L;
  const int j = (per + slots - 1) / slots;
#define POLAR_ENCODE_J(JJ)                                                                 \
  if (j <= JJ)                                                                             \
    return launch<T, V, JJ>(k, sb, sh, sn, st, B, H, G, g, P, pages, codes, rs, rz, ts, tz, \
                            r_bits, t_bits, fixed, tstep, threads, s);
  POLAR_ENCODE_J(1)
  POLAR_ENCODE_J(2)
  POLAR_ENCODE_J(4)
  POLAR_ENCODE_J(8)
#undef POLAR_ENCODE_J
  return static_cast<int>(cudaErrorInvalidValue);  // a tile too large for one cluster
}

template <typename T>
int dispatch(const void* k, long long sb, long long sh, long long sn, long long st, int B,
             int H, int G, int g, int P, const int* pages, void* codes, void* rs, void* rz,
             void* ts, void* tz, int r_bits, int t_bits, int fixed, float tstep,
             cudaStream_t s) {
  const auto* kp = static_cast<const T*>(k);
  auto* c = static_cast<unsigned char*>(codes);
  auto* a = static_cast<float*>(rs);
  auto* z = static_cast<float*>(rz);
  auto* e = static_cast<float*>(ts);
  auto* w = static_cast<float*>(tz);
  // aligned runs of kVec pairs: every key row start and both halves on
  // the vector load's size, code rows on kVec bytes
  constexpr long long kBytes = kVec * sizeof(T) < 16 ? kVec * sizeof(T) : 16;
  constexpr long long kEl = kBytes / sizeof(T);
  const bool wide = P % kVec == 0 && reinterpret_cast<uintptr_t>(k) % kBytes == 0 &&
                    sb % kEl == 0 && sh % kEl == 0 && sn % kEl == 0 && st % kEl == 0 &&
                    reinterpret_cast<uintptr_t>(codes) % kVec == 0;
  if (wide)
    return launch_body<T, kVec>(kp, sb, sh, sn, st, B, H, G, g, P, pages, c, a, z, e, w,
                                r_bits, t_bits, fixed, tstep, kWideThreads, s);
  return launch_body<T, 1>(kp, sb, sh, sn, st, B, H, G, g, P, pages, c, a, z, e, w, r_bits,
                           t_bits, fixed, tstep, kNarrowThreads, s);
}

}  // namespace

// k: element strides (sb, sh, sn, st) for (row, head, group, token); the
// pair axis is contiguous. fixed != 0: the fixed angle grid of step tstep.
// Returns cudaGetLastError() after the launch.
extern "C" int polar_encode_launch(const void* k, int k_bf16, long long sb, long long sh,
                                   long long sn, long long st, int B, int H, int G, int g,
                                   int d, const int* pages, void* codes, void* rs, void* rz,
                                   void* ts, void* tz, int r_bits, int t_bits, int fixed,
                                   float tstep, void* stream) {
  const int P = d / 2;
  if (P <= 0 || g <= 0 || B <= 0 || H <= 0 || G <= 0 || H > 65535 || B > 65535 ||
      static_cast<long long>(G) * kCluster > 0x7fffffff || r_bits + t_bits > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (k_bf16)
    return dispatch<__nv_bfloat16>(k, sb, sh, sn, st, B, H, G, g, P, pages, codes, rs, rz, ts,
                                   tz, r_bits, t_bits, fixed, tstep, s);
  return dispatch<float>(k, sb, sh, sn, st, B, H, G, g, P, pages, codes, rs, rz, ts, tz,
                         r_bits, t_bits, fixed, tstep, s);
}
