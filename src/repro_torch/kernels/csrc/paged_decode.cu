// Page-native fused PolarQuant decode attention over the flushed groups
// (replaces the Pallas kernel repro/kernels/paged_decode.py::
// polar_paged_decode_grouped and its LUT tile
// repro/kernels/polar_attention.py::_lut_scores_block).
//
// One block per (kv head h, slot s), covering all Qh query heads of the
// group. The block walks the slot's page-table row over its LIVE pages
// only (ceil(flushed[s] / g)); for each page it
//   1. loads the page's four stat rows,
//   2. builds cos/sin of the 2^t angle states per pair and from them the
//      LUT A[qh][p][a] = q_x cos(th~ - pi) + q_y sin(th~ - pi) in shared
//      memory (a real gather replaces the TPU's 2^t select tree),
//   3. scores every (query head, token): sum_p rho~[t,p] A[qh][p][code],
//      masked at pos >= flushed[s],
//   4. runs the online-softmax update (one warp per query head),
//   5. accumulates p @ V with value rows past flushed[s] zeroed, so a
//      NaN-poisoned page row can never reach the sum.
// It returns the unnormalized flash partials (acc, m, l) in fp32; the
// residual merge stays in PyTorch (kernels/ops.py).
//
// Bound: bytes — each live page's codes (g*P B), stats (4*P*4 B) and
// value rows (g*d*2 B in bf16) are read once per (slot, kv head). The
// grid is only S*Hkv blocks (32 at 8 slots x 4 kv heads), far below the
// 132 SMs: splitting pages across blocks is the first thing to fix.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename TV>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const float* __restrict__ q, const unsigned char* __restrict__ codes,
    const float* __restrict__ rs, const float* __restrict__ rz, const float* __restrict__ ts,
    const float* __restrict__ tz, const TV* __restrict__ values, const int* __restrict__ table,
    long long table_stride, int N, const int* __restrict__ flushed, float* __restrict__ acc_out,
    float* __restrict__ m_out, float* __restrict__ l_out, int Hkv, int Qh, int d, int g,
    int PP, int t_bits) {
  extern __shared__ float smem[];
  const int h = blockIdx.x, s = blockIdx.y;
  const int P = d / 2, NT = 1 << t_bits;
  const unsigned tmask = static_cast<unsigned>(NT - 1);
  float* q_s = smem;                  // (Qh, d)
  float* cos_s = q_s + Qh * d;        // (P, NT)
  float* sin_s = cos_s + P * NT;      // (P, NT)
  float* lut = sin_s + P * NT;        // (Qh, P, NT)
  float* st = lut + Qh * P * NT;      // rho scale, rho zero, theta scale, theta zero: (4, P)
  float* sc = st + 4 * P;             // scores, then probabilities: (Qh, g)
  float* acc_s = sc + Qh * g;         // (Qh, d)
  float* m_s = acc_s + Qh * d;        // (Qh,)
  float* l_s = m_s + Qh;
  float* corr_s = l_s + Qh;

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, nwarps = nthr / 32;
  const long long sh = static_cast<long long>(s) * Hkv + h;
  for (int i = tid; i < Qh * d; i += nthr) {
    q_s[i] = q[sh * Qh * d + i];
    acc_s[i] = 0.0f;
  }
  for (int i = tid; i < Qh; i += nthr) {
    m_s[i] = rt::kNegInf;
    l_s[i] = 0.0f;
  }
  const int fl = flushed[s];
  const int npages = min((fl + g - 1) / g, N);

  for (int n = 0; n < npages; ++n) {
    const int page = table[s * table_stride + n];
    __syncthreads();  // the previous page's readers are done with st/lut/sc
    if (page < 0 || page >= PP) continue;  // uniform across the block
    const long long ph = static_cast<long long>(page) * Hkv + h;
    for (int i = tid; i < 4 * P; i += nthr) {
      const int which = i / P, p = i % P;
      const float* src = which == 0 ? rs : which == 1 ? rz : which == 2 ? ts : tz;
      st[i] = src[ph * P + p];
    }
    __syncthreads();
    for (int i = tid; i < P * NT; i += nthr) {
      const int p = i / NT, a = i % NT;
      const float th = (static_cast<float>(a) + 0.5f) * st[2 * P + p] + st[3 * P + p];
      float sn, cs;
      sincosf(th - rt::kPi, &sn, &cs);
      cos_s[i] = cs;
      sin_s[i] = sn;
    }
    __syncthreads();
    for (int i = tid; i < Qh * P * NT; i += nthr) {
      const int qh = i / (P * NT), r = i % (P * NT), p = r / NT;
      lut[i] = q_s[qh * d + p] * cos_s[r] + q_s[qh * d + P + p] * sin_s[r];
    }
    __syncthreads();
    const unsigned char* cpage = codes + ph * g * P;
    for (int i = tid; i < Qh * g; i += nthr) {
      const int qh = i / g, t = i % g;
      const unsigned char* crow = cpage + t * P;
      const float* lq = lut + qh * P * NT;
      float acc = 0.0f;
      for (int p = 0; p < P; ++p) {
        const unsigned c = crow[p];
        const float rho = (static_cast<float>(c >> t_bits) + 0.5f) * st[p] + st[P + p];
        acc += rho * lq[p * NT + (c & tmask)];
      }
      sc[i] = n * g + t < fl ? acc : rt::kNegInf;
    }
    __syncthreads();
    for (int qh = warp; qh < Qh; qh += nwarps) {
      float mx = rt::kNegInf;
      for (int t = lane; t < g; t += 32) mx = fmaxf(mx, sc[qh * g + t]);
      mx = rt::warp_max(mx);
      const float m_old = m_s[qh];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int t = lane; t < g; t += 32) {
        const float pr = n * g + t < fl ? expf(sc[qh * g + t] - m_new) : 0.0f;
        sc[qh * g + t] = pr;
        sum += pr;
      }
      sum = rt::warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[qh] = corr;
        l_s[qh] = l_s[qh] * corr + sum;
        m_s[qh] = m_new;
      }
    }
    __syncthreads();
    const TV* vpage = values + ph * g * d;
    for (int i = tid; i < Qh * d; i += nthr) {
      const int qh = i / d, dd = i % d;
      const float* pr = sc + qh * g;
      float a = acc_s[i] * corr_s[qh];
      for (int t = 0; t < g; ++t) {
        // dead rows read as exact zeros: 0 * NaN never enters the sum
        const float v = n * g + t < fl ? rt::to_f32(vpage[t * d + dd]) : 0.0f;
        a += pr[t] * v;
      }
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

size_t smem_bytes(int Qh, int d, int g, int t_bits) {
  const int P = d / 2, NT = 1 << t_bits;
  return sizeof(float) *
         static_cast<size_t>(2 * Qh * d + 2 * P * NT + Qh * P * NT + 4 * P + Qh * g + 3 * Qh);
}

template <typename TV>
int launch(const float* q, const unsigned char* codes, const float* rs, const float* rz,
           const float* ts, const float* tz, const void* values, const int* table,
           long long table_stride, int N, const int* flushed, float* acc, float* m, float* l,
           int S, int Hkv, int Qh, int d, int g, int PP, int t_bits, cudaStream_t stream) {
  const size_t smem = smem_bytes(Qh, d, g, t_bits);
  cudaError_t err = rt::allow_smem(paged_decode_kernel<TV>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hkv, S);
  paged_decode_kernel<TV><<<grid, kThreads, smem, stream>>>(
      q, codes, rs, rz, ts, tz, static_cast<const TV*>(values), table, table_stride, N,
      flushed, acc, m, l, Hkv, Qh, d, g, PP, t_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (S, Hkv, Qh, d) fp32 pre-scaled; pools codes (PP, Hkv, g, d/2) uint8,
// stats (PP, Hkv, 1, d/2) fp32, values (PP, Hkv, g, d) bf16 or fp32;
// table (S, >=N) int32 with row stride table_stride; flushed (S,) int32.
// Outputs acc (S, Hkv, Qh, d), m and l (S, Hkv, Qh), all fp32.
extern "C" int paged_decode_launch(const void* q, const void* codes, const void* rs,
                                   const void* rz, const void* ts, const void* tz,
                                   const void* values, int v_bf16, const void* table,
                                   long long table_stride, int N, const void* flushed,
                                   void* acc, void* m, void* l, int S, int Hkv, int Qh, int d,
                                   int g, int PP, int t_bits, void* stream) {
  if (S <= 0 || Hkv <= 0 || Qh <= 0 || d <= 0 || d % 2 || g <= 0 || S > 65535 || t_bits > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const unsigned char*>(codes);
  const auto* tab = static_cast<const int*>(table);
  const auto* fl = static_cast<const int*>(flushed);
  auto* a = static_cast<float*>(acc);
  auto* mm = static_cast<float*>(m);
  auto* ll = static_cast<float*>(l);
  if (v_bf16)
    return launch<__nv_bfloat16>(f(q), c, f(rs), f(rz), f(ts), f(tz), values, tab,
                                 table_stride, N, fl, a, mm, ll, S, Hkv, Qh, d, g, PP,
                                 t_bits, st);
  return launch<float>(f(q), c, f(rs), f(rz), f(ts), f(tz), values, tab, table_stride, N, fl,
                       a, mm, ll, S, Hkv, Qh, d, g, PP, t_bits, st);
}
