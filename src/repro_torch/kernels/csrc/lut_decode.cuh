// The LUT flash-decode bodies shared by the page-walking decode kernel
// (paged_decode.cu) and the dense-cache decode kernel (polar_attention.cu),
// plus the per-group angle LUT that the score-only kernel (polar_qk.cu)
// builds the same way.
//
// A `Groups` policy maps (row s, kv head h, group n) to the group's index
// in the code / stat / value buffers, or -1 for an unassigned group. Per
// group, every query head of the kv head
//   1. stages the four stat rows, the (g, P) codes and the (g, d) value
//      rows in shared memory, value rows past live[s] as exact zeros, so a
//      NaN-poisoned row never reaches a sum (uint8 value codes with their
//      row scale and zero: the TPU kernels' uint8 branch);
//   2. builds the LUT A[qh][p][a] = q_x cos(th~ - pi) + q_y sin(th~ - pi)
//      of the 2^t angle states (a real gather replaces the TPU's 2^t
//      select tree);
//   3. scores every (query head, token): sum_p rho~[t,p] A[qh][p][code],
//      masked at pos >= live[s];
//   4. runs the online-softmax update (one warp per query head);
//   5. accumulates p @ V from the staged rows. uint8 rows dequantize as
//      c * scale + zero: the unsplit body while it stages them (fp32 rows
//      in shared memory), the split body by folding the scale into the
//      probability, sum_t p_t (c_t s_t + z_t) = sum_t (p_t s_t) c_t +
//      sum_t p_t z_t, which keeps p @ V at one FMA per element.
// Both bodies return the unnormalized flash partials (acc, m, l) in fp32;
// the residual merge stays in PyTorch (kernels/ops.py).
//
// Bound: bytes — each live group's codes, stats and value rows are read
// once per (row, kv head). A group is a short dependent chain (DRAM round
// trip, sincos of the angle states, scoring, softmax, p @ V), so the time
// follows how many chains run at once and whether the next group's loads
// are in flight:
// - lut_split_decode_kernel (page walk, #2, and dense cache, #5): the walk
//   is split across blocks, grid (Hkv, S, nsplit) with the host's nsplit
//   (8 slots x 4 kv heads x 8 pages: 256 blocks; 8 rows x 4 kv heads x 9
//   dense groups: 160), and a second small kernel merges the splits
//   exactly; inside a split the groups are double-buffered (16-byte
//   cp.async), so group n + 1 loads while group n is scored, and a scoring
//   thread owns one token for 4 query heads. Where two staging buffers do
//   not fit a block's shared memory (bf16 rows at d 256 with 8 query
//   heads: 258,176 B against 232,448), the walk runs on one buffer, which
//   loads group n + 1 after group n is done.
// - lut_flash_decode_kernel (both kernels, for the shapes the split body
//   does not take: d % 32 != 0, unaligned buffers): one block per (kv
//   head, row) walks the row's live groups one after another, all of a
//   group's 16-byte register loads in flight together (codes transposed
//   to (P, g)).
#pragma once

#include <cstdint>

#include "mma.cuh"

namespace rt {

constexpr int kDecodeThreads = 256;

// The four stat rows of one group (rho scale, rho zero, theta scale,
// theta zero), each P floats at `off` in its buffer, into st[4 * P].
__device__ __forceinline__ void load_group_stats(float* st, const float* __restrict__ rs,
                                                 const float* __restrict__ rz,
                                                 const float* __restrict__ ts,
                                                 const float* __restrict__ tz, long long off,
                                                 int P) {
  for (int p = threadIdx.x; p < P; p += blockDim.x) {
    st[p] = rs[off + p];
    st[P + p] = rz[off + p];
    st[2 * P + p] = ts[off + p];
    st[3 * P + p] = tz[off + p];
  }
}

// The LUT lut[qh][p][a] = q_x cos(th~ - pi) + q_y sin(th~ - pi) of the
// group's 2^t angle states (from st's theta rows) for every query row of
// q_s (Qh, d): one sincos per (pair, state), then one product pair per
// query row. Syncs the block after the pass.
__device__ __forceinline__ void build_angle_lut(const float* q_s, const float* st, float* lut,
                                                int Qh, int d, int t_bits) {
  const int P = d / 2, NT = 1 << t_bits;
  for (int r = threadIdx.x; r < P * NT; r += blockDim.x) {
    const int p = r >> t_bits, a = r & (NT - 1);
    const float th = (static_cast<float>(a) + 0.5f) * st[2 * P + p] + st[3 * P + p];
    float sn, cs;
    sincosf(th - kPi, &sn, &cs);
    for (int qh = 0; qh < Qh; ++qh)
      lut[qh * P * NT + r] = q_s[qh * d + p] * cs + q_s[qh * d + P + p] * sn;
  }
  __syncthreads();
}

inline size_t lut_decode_smem_bytes(int Qh, int d, int g, int t_bits) {
  const int P = d / 2, NT = 1 << t_bits;
  return sizeof(float) *
             static_cast<size_t>(2 * Qh * d + Qh * P * NT + 4 * P + Qh * g + 3 * Qh + g * d) +
         static_cast<size_t>(g) * P;
}

// q (S, Hkv, Qh, d) fp32 pre-scaled; codes: one (g, P) uint8 tile per group
// index; stats: P floats per group index; values: one (g, d) tile per group
// index (uint8: vscale / vzero hold g floats per group index, else unused);
// live (S,) int32 valid tokens per row. Outputs acc (S, Hkv, Qh, d),
// m and l (S, Hkv, Qh). Grid (Hkv, S), kDecodeThreads threads,
// lut_decode_smem_bytes of dynamic shared memory.
template <typename TV, typename Groups>
__global__ void __launch_bounds__(kDecodeThreads) lut_flash_decode_kernel(
    const float* __restrict__ q, const unsigned char* __restrict__ codes,
    const float* __restrict__ rs, const float* __restrict__ rz, const float* __restrict__ ts,
    const float* __restrict__ tz, const TV* __restrict__ values,
    const float* __restrict__ vscale, const float* __restrict__ vzero, Groups groups,
    const int* __restrict__ live, float* __restrict__ acc_out, float* __restrict__ m_out,
    float* __restrict__ l_out, int Hkv, int Qh, int d, int g, int t_bits) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, s = blockIdx.y;
  const int P = d / 2, NT = 1 << t_bits;
  const unsigned tmask = static_cast<unsigned>(NT - 1);
  float* q_s = smem;                  // (Qh, d)
  float* lut = q_s + Qh * d;          // (Qh, P, NT)
  float* st = lut + Qh * P * NT;      // rho scale, rho zero, theta scale, theta zero: (4, P)
  float* sc = st + 4 * P;             // scores, then probabilities: (Qh, g)
  float* acc_s = sc + Qh * g;         // (Qh, d)
  float* m_s = acc_s + Qh * d;        // (Qh,)
  float* l_s = m_s + Qh;
  float* corr_s = l_s + Qh;
  float* v_s = corr_s + Qh;           // value rows, dead rows zeroed: (g, d)
  auto* c_s = reinterpret_cast<unsigned char*>(v_s + g * d);  // codes: (P, g)

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nthr / 32;
  const long long sh = static_cast<long long>(s) * Hkv + h;
  for (int i = tid; i < Qh * d; i += nthr) {
    q_s[i] = q[sh * Qh * d + i];
    acc_s[i] = 0.0f;
  }
  for (int i = tid; i < Qh; i += nthr) {
    m_s[i] = kNegInf;
    l_s[i] = 0.0f;
  }
  const int fl = live[s];
  const int ngroups = min((fl + g - 1) / g, groups.count);

  for (int n = 0; n < ngroups; ++n) {
    const long long grp = groups.index(s, h, n);
    __syncthreads();  // the previous group's readers are done with the tiles
    if (grp < 0) continue;  // uniform across the block
    load_group_stats(st, rs, rz, ts, tz, grp * P, P);
    // 16-byte loads, so that the group's whole tile is in flight at once
    // (the launch checks alignment and that g*P and g*d divide evenly)
    const auto* cgrp = reinterpret_cast<const uint4*>(codes + grp * g * P);
#pragma unroll 2
    for (int j = tid; j < g * P / 16; j += nthr) {
      const uint4 raw = cgrp[j];
      const auto* e = reinterpret_cast<const unsigned char*>(&raw);
#pragma unroll
      for (int k = 0; k < 16; ++k) c_s[((j * 16 + k) % P) * g + (j * 16 + k) / P] = e[k];
    }
    constexpr int kVec = 16 / sizeof(TV);
    const auto* vgrp = reinterpret_cast<const uint4*>(values + grp * g * d);
    const int nlive = min(fl - n * g, g);  // rows of this group below live[s]
#pragma unroll 8
    for (int j = tid; j < g * d / kVec; j += nthr) {
      const uint4 raw = vgrp[j];
      const auto* e = reinterpret_cast<const TV*>(&raw);
      if constexpr (kQuantV<TV>) {
        // d % 16 == 0 (checked at launch): the 16 codes share one row
        const int r = j * kVec / d;
        const bool row_live = r < nlive;
        const float vs = row_live ? vscale[grp * g + r] : 0.0f;
        const float vz = row_live ? vzero[grp * g + r] : 0.0f;
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          v_s[j * kVec + k] = row_live ? fmaf(to_f32(e[k]), vs, vz) : 0.0f;
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          // dead rows read as exact zeros: 0 * NaN never enters the sum
          const int i = j * kVec + k;
          v_s[i] = i < nlive * d ? to_f32(e[k]) : 0.0f;
        }
      }
    }
    __syncthreads();
    build_angle_lut(q_s, st, lut, Qh, d, t_bits);
    for (int i = tid; i < Qh * g; i += nthr) {
      const int qh = i / g, t = i % g;
      const float* lq = lut + qh * P * NT;
      float acc = 0.0f;
      for (int p = 0; p < P; ++p) {
        const unsigned c = c_s[p * g + t];
        const float rho = (static_cast<float>(c >> t_bits) + 0.5f) * st[p] + st[P + p];
        acc += rho * lq[p * NT + (c & tmask)];
      }
      sc[i] = t < nlive ? acc : kNegInf;
    }
    __syncthreads();
    for (int qh = warp; qh < Qh; qh += nwarps) {
      float mx = kNegInf;
      for (int t = lane; t < g; t += 32) mx = fmaxf(mx, sc[qh * g + t]);
      mx = warp_max(mx);
      const float m_old = m_s[qh];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int t = lane; t < g; t += 32) {
        const float pr = t < nlive ? expf(sc[qh * g + t] - m_new) : 0.0f;
        sc[qh * g + t] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[qh] = corr;
        l_s[qh] = l_s[qh] * corr + sum;
        m_s[qh] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < Qh * d; i += nthr) {
      const int qh = i / d, dd = i % d;
      const float* pr = sc + qh * g;
      float a = acc_s[i] * corr_s[qh];
      for (int t = 0; t < g; ++t) a += pr[t] * v_s[t * d + dd];
      acc_s[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < Qh * d; i += nthr) acc_out[sh * Qh * d + i] = acc_s[i];
  for (int i = tid; i < Qh; i += nthr) {
    m_out[sh * Qh + i] = m_s[i];
    l_out[sh * Qh + i] = l_s[i];
  }
}

// Launch lut_flash_decode_kernel over grid (Hkv, S).
template <typename TV, typename Groups>
int launch_lut_flash_decode(const float* q, const unsigned char* codes, const float* rs,
                            const float* rz, const float* ts, const float* tz,
                            const void* values, const float* vscale, const float* vzero,
                            Groups groups, const int* live, float* acc, float* m, float* l,
                            int S, int Hkv, int Qh, int d, int g, int t_bits,
                            cudaStream_t stream) {
  if (kQuantV<TV> && (d % 16 || vscale == nullptr || vzero == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // the staging loads read 16-byte vectors of codes and value rows
  if ((g * (d / 2)) % 16 || (g * d * sizeof(TV)) % 16 ||
      reinterpret_cast<uintptr_t>(codes) % 16 || reinterpret_cast<uintptr_t>(values) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const size_t smem = lut_decode_smem_bytes(Qh, d, g, t_bits);
  cudaError_t err = allow_smem(lut_flash_decode_kernel<TV, Groups>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hkv, S);
  lut_flash_decode_kernel<TV, Groups><<<grid, kDecodeThreads, smem, stream>>>(
      q, codes, rs, rz, ts, tz, static_cast<const TV*>(values), vscale, vzero, groups, live,
      acc, m, l, Hkv, Qh, d, g, t_bits);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// split, double-buffered body (paged_decode.cu and polar_attention.cu)
// ---------------------------------------------------------------------------

constexpr int kSplitStages = 2;  // staging buffers per block where they fit (1: no prefetch)
constexpr int kQG = 4;           // query heads a scoring thread carries

// Bytes of lut_split_decode_kernel's shared memory: q (Qh, d), the LUT
// (Qh, P, 2^t), scores (Qh, g), acc (Qh, d) and m / l / corr / sum_t p_t z_t
// (Qh) as fp32, rounded to 16 bytes; then kSplitStages stages of stats
// (4, P) fp32, value rows (g, d) TV, for uint8 rows their scales and zeros
// (2, g) fp32, and code rows (g, P) padded to P + 16 bytes (which makes the
// 16-byte row reads of eight neighbouring tokens conflict-free).
__host__ __device__ inline size_t lut_split_head_bytes(int Qh, int d, int g, int t_bits) {
  const int P = d / 2, NT = 1 << t_bits;
  const size_t f = static_cast<size_t>(Qh) * (2 * d + P * NT + g + 4);
  return (f * sizeof(float) + 15) / 16 * 16;
}
__host__ __device__ inline size_t lut_split_stage_bytes(int d, int g, size_t tv, bool quant) {
  const int P = d / 2;
  return static_cast<size_t>(16 * P) + static_cast<size_t>(g) * d * tv +
         (quant ? static_cast<size_t>(8) * g : 0) + static_cast<size_t>(g) * (P + 16);
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// two uint8 codes as exact floats: 2^23 + c has c in its low mantissa bits,
// so an OR and an FADD replace the slower integer-to-float conversion
__device__ __forceinline__ float2 load_pair(const unsigned char* p) {
  const unsigned w = *reinterpret_cast<const unsigned short*>(p);
  return make_float2(__uint_as_float(0x4B000000u | (w & 0xffu)) - 8388608.0f,
                     __uint_as_float(0x4B000000u | (w >> 8)) - 8388608.0f);
}

// The same partials as lut_flash_decode_kernel over groups
// [z * per_split, (z + 1) * per_split) of each row, z = blockIdx.z: grid
// (Hkv, S, nsplit). Outputs at [(z * S + s) * Hkv + h]: the split
// partials, merged by merge_splits_kernel, or the final (acc, m, l) when
// nsplit == 1. A split that holds no live group writes m = kNegInf, l = 0,
// acc = 0. Inside a split, group n + 1's stats, codes and value rows are
// in flight (16-byte cp.async into the other stage) while group n is
// scored; value rows past live[s] are copied with the predicate off, so
// they land as exact zeros (uint8 rows: codes, scale and zero all zero).
// Needs d % 32 == 0 and 16-byte aligned buffers. kStages: the staging
// buffers (2: double-buffered; 1: the next group loads after this one).
template <typename TV, typename Groups, int kStages>
__global__ void __launch_bounds__(kDecodeThreads) lut_split_decode_kernel(
    const float* __restrict__ q, const unsigned char* __restrict__ codes,
    const float* __restrict__ rs, const float* __restrict__ rz, const float* __restrict__ ts,
    const float* __restrict__ tz, const TV* __restrict__ values,
    const float* __restrict__ vscale, const float* __restrict__ vzero, Groups groups,
    const int* __restrict__ live, float* __restrict__ acc_out, float* __restrict__ m_out,
    float* __restrict__ l_out, int Hkv, int Qh, int d, int g, int t_bits, int per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.x, s = blockIdx.y, z = blockIdx.z;
  const int P = d / 2, NT = 1 << t_bits, CS = P + 16;
  const unsigned tmask = static_cast<unsigned>(NT - 1);
  auto* q_s = reinterpret_cast<float*>(smem_raw);  // (Qh, d)
  float* lut = q_s + Qh * d;                        // (Qh, P, NT)
  float* sc = lut + Qh * P * NT;                    // scores, then probabilities: (Qh, g)
  float* acc_s = sc + Qh * g;                       // (Qh, d)
  float* m_s = acc_s + Qh * d;                      // (Qh,)
  float* l_s = m_s + Qh;
  float* corr_s = l_s + Qh;
  float* pz_s = corr_s + Qh;                        // uint8 rows: sum_t p_t z_t (Qh,)
  constexpr bool kQ = kQuantV<TV>;
  unsigned char* stage0 = smem_raw + lut_split_head_bytes(Qh, d, g, t_bits);
  const size_t stage_bytes = lut_split_stage_bytes(d, g, sizeof(TV), kQ);
  const size_t vbytes = static_cast<size_t>(g) * d * sizeof(TV) + (kQ ? 8 * g : 0);
  auto st_of = [&](int b) { return reinterpret_cast<float*>(stage0 + b * stage_bytes); };
  auto v_of = [&](int b) { return reinterpret_cast<TV*>(stage0 + b * stage_bytes + 16 * P); };
  auto sz_of = [&](int b) {  // uint8 rows: scales (g), then zeros (g)
    return reinterpret_cast<float*>(stage0 + b * stage_bytes + 16 * P +
                                    static_cast<size_t>(g) * d * sizeof(TV));
  };
  auto c_of = [&](int b) { return stage0 + b * stage_bytes + 16 * P + vbytes; };

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nthr / 32;
  const long long sh = static_cast<long long>(s) * Hkv + h;
  const long long oi = static_cast<long long>(z) * gridDim.y * Hkv + sh;
  for (int i = tid; i < Qh * d; i += nthr) {
    q_s[i] = q[sh * Qh * d + i];
    acc_s[i] = 0.0f;
  }
  for (int i = tid; i < Qh; i += nthr) {
    m_s[i] = kNegInf;
    l_s[i] = 0.0f;
  }
  const int fl = live[s];
  const int n_end = min(min((fl + g - 1) / g, groups.count), (z + 1) * per_split);
  const int n_begin = z * per_split;

  // group n's stats, codes and value rows into stage b (nothing for an
  // unassigned group, which the walk skips)
  constexpr int kVec = 16 / sizeof(TV);
  auto fetch = [&](int n, int b) {
    const long long grp = groups.index(s, h, n);
    if (grp < 0) return;
    float* st = st_of(b);
    for (int c = tid; c < P; c += nthr) {  // 4 stat rows of P/4 chunks
      const int which = c / (P / 4), off = (c % (P / 4)) * 4;
      const float* src = which == 0 ? rs : which == 1 ? rz : which == 2 ? ts : tz;
      cp_async16(st + which * P + off, src + grp * P + off, true);
    }
    unsigned char* cs = c_of(b);
    const unsigned char* cg = codes + grp * g * P;
    for (int c = tid; c < g * P / 16; c += nthr) {
      const int r = c / (P / 16), col = (c % (P / 16)) * 16;
      cp_async16(cs + r * CS + col, cg + r * P + col, true);
    }
    TV* vs = v_of(b);
    const TV* vg = values + grp * g * d;
    const int nlive = min(fl - n * g, g);  // rows of this group below live[s]
    for (int c = tid; c < g * d / kVec; c += nthr)
      cp_async16(vs + c * kVec, vg + c * kVec, c / (d / kVec) < nlive);
    if constexpr (kQ) {  // the rows' scales then zeros, dead rows as zeros
      float* sz = sz_of(b);
      for (int c = tid; c < 2 * g; c += nthr) {
        const int r = c % g;
        cp_async4(sz + c, (c < g ? vscale : vzero) + grp * g + r, r < nlive);
      }
    }
  };

  const int nn = n_end - n_begin;
  if (nn > 0) {
    fetch(n_begin, 0);
    cp_async_commit();
  }
  for (int k = 0; k < nn; ++k) {
    const int n = n_begin + k, b = k % kStages;
    if (kStages > 1 && k + 1 < nn) {
      fetch(n + 1, (k + 1) % kStages);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (groups.index(s, h, n) >= 0) {  // uniform across the block
      const float* st = st_of(b);
      const TV* vs = v_of(b);
      const float* sz = sz_of(b);
      const unsigned char* cs = c_of(b);
      const int nlive = min(fl - n * g, g);
      build_angle_lut(q_s, st, lut, Qh, d, t_bits);
      // scores: a thread owns one token and kQG query heads, so each code
      // and rho~ is read once for all of them
      const int nqg = (Qh + kQG - 1) / kQG;
      for (int i = tid; i < g * nqg; i += nthr) {
        const int t = i % g, qg = i / g;
        float a[kQG];
#pragma unroll
        for (int u = 0; u < kQG; ++u) a[u] = 0.0f;
        for (int p0 = 0; p0 < P; p0 += 16) {
          const uint4 raw = *reinterpret_cast<const uint4*>(cs + t * CS + p0);
          const auto* e = reinterpret_cast<const unsigned char*>(&raw);
#pragma unroll
          for (int k2 = 0; k2 < 16; ++k2) {
            const int p = p0 + k2;
            const unsigned c = e[k2];
            const float rho = (static_cast<float>(c >> t_bits) + 0.5f) * st[p] + st[P + p];
            const float* lp = lut + (qg * kQG) * P * NT + p * NT + (c & tmask);
#pragma unroll
            for (int u = 0; u < kQG; ++u)
              if (qg * kQG + u < Qh) a[u] += rho * lp[u * P * NT];
          }
        }
#pragma unroll
        for (int u = 0; u < kQG; ++u)
          if (qg * kQG + u < Qh) sc[(qg * kQG + u) * g + t] = t < nlive ? a[u] : kNegInf;
      }
      __syncthreads();
      for (int qh = warp; qh < Qh; qh += nwarps) {
        float mx = kNegInf;
        for (int t = lane; t < g; t += 32) mx = fmaxf(mx, sc[qh * g + t]);
        mx = warp_max(mx);
        const float m_old = m_s[qh];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.0f, zsum = 0.0f;
        for (int t = lane; t < g; t += 32) {
          const float pr = t < nlive ? expf(sc[qh * g + t] - m_new) : 0.0f;
          sum += pr;
          if constexpr (kQ) {  // p_t s_t for p @ codes, sum_t p_t z_t aside
            zsum += pr * sz[g + t];
            sc[qh * g + t] = pr * sz[t];
          } else {
            sc[qh * g + t] = pr;
          }
        }
        sum = warp_sum(sum);
        if (kQ) zsum = warp_sum(zsum);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          corr_s[qh] = corr;
          pz_s[qh] = zsum;
          l_s[qh] = l_s[qh] * corr + sum;
          m_s[qh] = m_new;
        }
      }
      __syncthreads();
      // p @ V: a thread owns two neighbouring columns of one query head
      // (uint8 rows: codes weighted by p_t s_t, plus sum_t p_t z_t)
      for (int i = tid; i < Qh * P; i += nthr) {
        const int qh = i / P, c2 = (i % P) * 2;
        const float* pr = sc + qh * g;
        const float corr = corr_s[qh], pz = kQ ? pz_s[qh] : 0.0f;
        float a0 = acc_s[qh * d + c2] * corr + pz, a1 = acc_s[qh * d + c2 + 1] * corr + pz;
        for (int t = 0; t < g; ++t) {
          const float2 v = load_pair(vs + t * d + c2);
          a0 += pr[t] * v.x;
          a1 += pr[t] * v.y;
        }
        acc_s[qh * d + c2] = a0;
        acc_s[qh * d + c2 + 1] = a1;
      }
    }
    __syncthreads();  // every thread is done with stage b before it refills
    if (kStages == 1 && k + 1 < nn) {
      fetch(n + 1, 0);
      cp_async_commit();
    }
  }
  for (int i = tid; i < Qh * d; i += nthr) acc_out[oi * Qh * d + i] = acc_s[i];
  for (int i = tid; i < Qh; i += nthr) {
    m_out[oi * Qh + i] = m_s[i];
    l_out[oi * Qh + i] = l_s[i];
  }
}

// Exact merge of nsplit flash partials per (row, kv head, query head) —
// m = max m_z, l = sum l_z e^(m_z - m), acc = sum acc_z e^(m_z - m), as
// kernels/ops.py::merge_softmax_partials. Grid (S * Hkv), one thread per
// (query head, column). A template, so that only a library that launches
// the split body compiles it.
template <typename T>
__global__ void merge_splits_kernel(const T* __restrict__ acc_p, const T* __restrict__ m_p,
                                    const T* __restrict__ l_p, T* __restrict__ acc,
                                    T* __restrict__ m, T* __restrict__ l, int nsplit, int SH,
                                    int Qh, int d) {
  const long long sh = blockIdx.x;
  for (int i = threadIdx.x; i < Qh * d; i += blockDim.x) {
    const int qh = i / d;
    const long long row = sh * Qh + qh;
    const long long zs = static_cast<long long>(SH) * Qh;  // row stride of a split
    T mt = m_p[row];
    for (int z = 1; z < nsplit; ++z) mt = fmaxf(mt, m_p[z * zs + row]);
    T a = 0.0f, lt = 0.0f;
    for (int z = 0; z < nsplit; ++z) {
      const T w = expf(m_p[z * zs + row] - mt);
      a += acc_p[(z * zs + row) * d + i % d] * w;
      lt += l_p[z * zs + row] * w;
    }
    acc[row * d + i % d] = a;
    if (i % d == 0) {
      m[row] = mt;
      l[row] = lt;
    }
  }
}

// Launch the split body over grid (Hkv, S, nsplit) and, for nsplit > 1,
// the merge, both on `stream`. The walk of N table entries splits into
// ranges of per_split = ceil(N / nsplit) groups, nsplit' = ceil(N /
// per_split) <= nsplit of them (kernels/paged_decode.py::split_ranges);
// `partials` holds nsplit' * S * Hkv * Qh * (d + 2) floats. The body runs
// on kSplitStages staging buffers where they fit the device's shared
// memory per block, else on one.
template <typename TV, typename Groups>
int launch_lut_split_decode(const float* q, const unsigned char* codes, const float* rs,
                            const float* rz, const float* ts, const float* tz,
                            const void* values, const float* vscale, const float* vzero,
                            Groups groups, const int* live, float* acc, float* m, float* l,
                            float* partials, int S, int Hkv, int Qh, int d, int g, int t_bits,
                            int N, int nsplit, cudaStream_t stream) {
  const int per_split = N > 0 && nsplit > 0 ? (N + nsplit - 1) / nsplit : 1;
  nsplit = N > 0 ? (N + per_split - 1) / per_split : 1;
  if (nsplit > 65535 || (nsplit > 1 && partials == nullptr) ||
      (kQuantV<TV> && (g % 4 || vscale == nullptr || vzero == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t head = lut_split_head_bytes(Qh, d, g, t_bits);
  const size_t stage = lut_split_stage_bytes(d, g, sizeof(TV), kQuantV<TV>);
  static const size_t optin = smem_optin_bytes();  // one device per process
  const bool staged = head + kSplitStages * stage <= optin;
  const size_t smem = head + (staged ? kSplitStages : 1) * stage;
  // refused here, not by the attribute call, whose error would stay the
  // last error and fail the next launch's check
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = staged ? lut_split_decode_kernel<TV, Groups, kSplitStages>
                       : lut_split_decode_kernel<TV, Groups, 1>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(S) * Hkv * Qh;
  float* pa = nsplit > 1 ? partials : acc;
  float* pm = nsplit > 1 ? partials + nsplit * rows * d : m;
  float* pl = nsplit > 1 ? pm + nsplit * rows : l;
  const dim3 grid(Hkv, S, nsplit);
  kernel<<<grid, kDecodeThreads, smem, stream>>>(
      q, codes, rs, rz, ts, tz, static_cast<const TV*>(values), vscale, vzero, groups, live,
      pa, pm, pl, Hkv, Qh, d, g, t_bits, per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  merge_splits_kernel<float><<<S * Hkv, Qh * d < 256 ? Qh * d : 256, 0, stream>>>(
      pa, pm, pl, acc, m, l, nsplit, S * Hkv, Qh, d);
  return static_cast<int>(cudaGetLastError());
}

// Whether launch_lut_split_decode takes these buffers (else the unsplit
// lut_flash_decode_kernel runs).
inline bool lut_split_decode_fits(int d, const void* codes, const void* rs, const void* rz,
                                  const void* ts, const void* tz, const void* values) {
  return d % 32 == 0 && aligned16(codes) && aligned16(rs) && aligned16(rz) && aligned16(ts) &&
         aligned16(tz) && aligned16(values);
}

}  // namespace rt
