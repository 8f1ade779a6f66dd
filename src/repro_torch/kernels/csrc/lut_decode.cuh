// The LUT flash-decode body shared by the page-walking decode kernel
// (paged_decode.cu) and the dense-cache decode kernel (polar_attention.cu),
// plus the per-group angle LUT that the score-only kernel (polar_qk.cu)
// builds the same way.
//
// One block per (kv head h, row s), covering all Qh query heads of the
// group. The block walks the row's LIVE quantization groups only
// (ceil(live[s] / g), capped at the row's group count); a `Groups` policy
// maps (s, h, n) to the group's index in the code / stat / value buffers,
// or -1 for an unassigned group. For each group it
//   1. stages the four stat rows, the (g, P) codes (transposed to (P, g),
//      so neighbouring threads read neighbouring bytes) and the (g, d)
//      value rows in shared memory — every load of the group in flight at
//      once, value rows past live[s] stored as exact zeros, so a
//      NaN-poisoned row never reaches a sum;
//   2. builds the LUT A[qh][p][a] = q_x cos(th~ - pi) + q_y sin(th~ - pi)
//      of the 2^t angle states (a real gather replaces the TPU's 2^t
//      select tree);
//   3. scores every (query head, token): sum_p rho~[t,p] A[qh][p][code],
//      masked at pos >= live[s];
//   4. runs the online-softmax update (one warp per query head);
//   5. accumulates p @ V from the staged rows.
// It returns the unnormalized flash partials (acc, m, l) in fp32; the
// residual merge stays in PyTorch (kernels/ops.py).
#pragma once

#include <cstdint>

#include "common.cuh"

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
// index; live (S,) int32 valid tokens per row. Outputs acc (S, Hkv, Qh, d),
// m and l (S, Hkv, Qh). Grid (Hkv, S), kDecodeThreads threads,
// lut_decode_smem_bytes of dynamic shared memory.
template <typename TV, typename Groups>
__global__ void __launch_bounds__(kDecodeThreads) lut_flash_decode_kernel(
    const float* __restrict__ q, const unsigned char* __restrict__ codes,
    const float* __restrict__ rs, const float* __restrict__ rz, const float* __restrict__ ts,
    const float* __restrict__ tz, const TV* __restrict__ values, Groups groups,
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
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        // dead rows read as exact zeros: 0 * NaN never enters the sum
        const int i = j * kVec + k;
        v_s[i] = i < nlive * d ? to_f32(e[k]) : 0.0f;
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
                            const void* values, Groups groups, const int* live, float* acc,
                            float* m, float* l, int S, int Hkv, int Qh, int d, int g,
                            int t_bits, cudaStream_t stream) {
  // the staging loads read 16-byte vectors of codes and value rows
  if ((g * (d / 2)) % 16 || (g * d * sizeof(TV)) % 16 ||
      reinterpret_cast<uintptr_t>(codes) % 16 || reinterpret_cast<uintptr_t>(values) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const size_t smem = lut_decode_smem_bytes(Qh, d, g, t_bits);
  cudaError_t err = allow_smem(lut_flash_decode_kernel<TV, Groups>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hkv, S);
  lut_flash_decode_kernel<TV, Groups><<<grid, kDecodeThreads, smem, stream>>>(
      q, codes, rs, rz, ts, tz, static_cast<const TV*>(values), groups, live, acc, m, l, Hkv,
      Qh, d, g, t_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt
