// LUT q.K~ scores over the dense grouped cache, no softmax (replaces the
// Pallas kernel repro/kernels/polar_qk.py::polar_qk_scores — the paper's
// Appendix-A kernel).
//
// One block per (group n, kv head h, row b) scores the group's g tokens
// for all Qh query heads of the kv head:
//   1. stages q (Qh, d), the four stat rows and the group's (g, P) codes,
//      transposed to (P, g) so neighbouring threads read neighbouring
//      bytes, in shared memory;
//   2. builds the angle LUT A[qh][p][a] (lut_decode.cuh, as the decode
//      kernels do);
//   3. each thread takes one token and up to kRows query heads: per pair
//      it dequantizes rho~ once (one FMA) and adds rho~ * A[qh][p][code]
//      for each of its rows (one FMA on a gathered LUT entry each).
// Every position of the (B, Hkv, Qh, G*g) output is written: a group not
// yet filled holds zero stats and scores to a finite 0, which the caller
// masks.
//
// Bound: bytes — codes (g*P B) and stats (4*P*4 B) per group, the fp32
// score rows written (Qh*g*4 B per group) — against 2*Qh*g*P flops of
// gathered FMAs. The score spill to memory is what the fused decode kernel
// (polar_attention.cu) removes.
#include "lut_decode.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 8;  // query heads per thread, in registers

__global__ void __launch_bounds__(kThreads) polar_qk_kernel(
    const float* __restrict__ q, const unsigned char* __restrict__ codes,
    const float* __restrict__ rs, const float* __restrict__ rz, const float* __restrict__ ts,
    const float* __restrict__ tz, float* __restrict__ out, int Hkv, int Qh, int d, int G, int g,
    int t_bits) {
  extern __shared__ float smem[];
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int P = d / 2, NT = 1 << t_bits;
  const unsigned tmask = static_cast<unsigned>(NT - 1);
  float* q_s = smem;                  // (Qh, d)
  float* lut = q_s + Qh * d;          // (Qh, P, NT)
  float* st = lut + Qh * P * NT;      // (4, P)
  auto* codes_s = reinterpret_cast<unsigned char*>(st + 4 * P);  // (P, g)

  const int tid = threadIdx.x, nthr = blockDim.x;
  const long long bh = static_cast<long long>(b) * Hkv + h;
  const long long grp = bh * G + n;
  for (int i = tid; i < Qh * d; i += nthr) q_s[i] = q[bh * Qh * d + i];
  rt::load_group_stats(st, rs, rz, ts, tz, grp * P, P);
  const unsigned char* cgrp = codes + grp * g * P;
  for (int i = tid; i < g * P; i += nthr) codes_s[(i % P) * g + i / P] = cgrp[i];
  __syncthreads();
  rt::build_angle_lut(q_s, st, lut, Qh, d, t_bits);

  const long long T = static_cast<long long>(G) * g;
  const int nchunk = (Qh + kRows - 1) / kRows;
  for (int w = tid; w < g * nchunk; w += nthr) {
    const int t = w % g, r0 = (w / g) * kRows;
    float acc[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) acc[j] = 0.0f;
    for (int p = 0; p < P; ++p) {
      const unsigned c = codes_s[p * g + t];
      const float rho = (static_cast<float>(c >> t_bits) + 0.5f) * st[p] + st[P + p];
      const float* lp = lut + p * NT + (c & tmask);
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        if (r0 + j < Qh) acc[j] += rho * lp[(r0 + j) * P * NT];
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (r0 + j < Qh) out[(bh * Qh + r0 + j) * T + static_cast<long long>(n) * g + t] = acc[j];
  }
}

size_t smem_bytes(int Qh, int d, int g, int t_bits) {
  const int P = d / 2, NT = 1 << t_bits;
  return sizeof(float) * static_cast<size_t>(Qh * d + Qh * P * NT + 4 * P) +
         static_cast<size_t>(g) * P;
}

}  // namespace

// q (B, Hkv, Qh, d) fp32; codes (B, Hkv, G, g, d/2) uint8; stats
// (B, Hkv, G, 1, d/2) fp32. Output scores (B, Hkv, Qh, G*g) fp32.
extern "C" int polar_qk_launch(const void* q, const void* codes, const void* rs, const void* rz,
                               const void* ts, const void* tz, void* out, int B, int Hkv,
                               int Qh, int d, int G, int g, int t_bits, void* stream) {
  if (B <= 0 || Hkv <= 0 || Qh <= 0 || d <= 0 || d % 2 || G <= 0 || g <= 0 || B > 65535 ||
      Hkv > 65535 || t_bits > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const size_t smem = smem_bytes(Qh, d, g, t_bits);
  cudaError_t err = rt::allow_smem(polar_qk_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(G, Hkv, B);
  polar_qk_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      f(q), static_cast<const unsigned char*>(codes), f(rs), f(rz), f(ts), f(tz),
      static_cast<float*>(out), Hkv, Qh, d, G, g, t_bits);
  return static_cast<int>(cudaGetLastError());
}
