// Page-native fused PolarQuant chunk-prefill attention (replaces the
// Pallas kernel repro/kernels/paged_prefill.py::polar_paged_prefill_grouped).
//
// One prefill chunk of Tc tokens attends to the slot's quantized prefix
// pages [0, start) and, causally, to its own fp keys. The chunk's queries
// arrive folded onto the head axis: per kv head j one tall operand of
// QT = (Hq/Hkv)*Tc pre-scaled rows, row = qh*Tc + t.
//
// Grid (ceil(QT / 64), Hkv): a block owns 64 query rows of one kv head, so
// at the serving shapes (QT = 8*256, Hkv = 4) the grid is 32 x 4 = 128
// blocks on 132 SMs. Every row's softmax lives in one block, so no
// cross-block merge is needed. Each block walks, on its own:
//   1. the live prefix pages only, start/g of them (start is page-aligned,
//      so every token of a walked page is live; start == 0 reads no page):
//      stage the page's stats, codes and value rows in shared memory,
//      build cos/sin of its 2^t angle states and rho~ of every (token,
//      pair), then score rho~ . (q_x cos(th~ - pi) + q_y sin(th~ - pi)) by
//      gather — the TPU's 2^t select tree is not needed — and fold the page
//      into the online softmax and p @ V;
//   2. the chunk's own fp tile in 64-key steps, only up to the block's
//      largest t_q: s = q . k masked by t_q >= t_k and t_k < chunk_len,
//      with key and value rows past chunk_len read as zeros. It feeds the
//      same m/l/acc carry.
// The output is acc / l (the l == 0 guard keeps fully masked rows finite),
// fp32 (Hkv, QT, d). A page id outside [0, PP - 1) — the scratch page —
// reads as zero codes, stats and values, as the plain version gathers it.
//
// Thread layout: thread tid owns query row tid % 64 (its q row lives in
// registers) and a quarter of the tokens (scores) or of the d columns
// (p @ V accumulator, registers). The 32 lanes of a warp hold 32
// consecutive rows and the same token or column, so every shared-memory
// read of codes, rho~, cos/sin, keys and values is a broadcast, and the
// score rows are padded by one float so the per-row reads do not conflict.
//
// Bound: operations. At start = 1024 and Tc = 256 the least work is
// ~2.0 GFLOP of fp32: a per-row LUT of 2^t entries per pair (3 flops
// each), one FMA per (row, token, pair) on a gathered LUT entry, rho~ once
// per (token, pair), the softmax, p @ V (one FMA per (row, token, column))
// and the chunk's causal tile; ~5.1 MB of pages, q, chunk K/V and output
// move once. That is ~30 us at the H100 SXM's 67 TFLOP/s fp32 peak
// (chip_smoke.py computes it from its inputs). This first version forms
// q_x cos + q_y sin per (row, token, pair) instead of gathering a per-row
// LUT (which would not fit in shared memory for 64 rows), so its score
// costs about twice the least work, and it runs everything as plain fp32
// FMAs from registers and shared-memory broadcasts; tensor-core tiles for
// the chunk tile and p @ V are later work.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBR = 64;                   // query rows per block
constexpr int kTG = kThreads / kBR;       // threads per query row
constexpr int kBK = 64;                   // chunk keys per tile

// One online-softmax step over the first `ncols` scores of every row
// (one warp per row). Masked scores are exactly kNegInf and get p = 0.
__device__ __forceinline__ void online_update(float* sc, int ss, int ncols, float* m_s,
                                              float* l_s, float* corr_s, int warp,
                                              int lane) {
  for (int r = warp; r < kBR; r += kThreads / 32) {
    float* srow = sc + r * ss;
    float mx = rt::kNegInf;
    for (int t = lane; t < ncols; t += 32) mx = fmaxf(mx, srow[t]);
    mx = rt::warp_max(mx);
    const float m_old = m_s[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.0f;
    for (int t = lane; t < ncols; t += 32) {
      const float s = srow[t];
      const float p = s > rt::kNegInf ? expf(s - m_new) : 0.0f;
      srow[t] = p;
      sum += p;
    }
    sum = rt::warp_sum(sum);
    if (lane == 0) {
      const float corr = expf(m_old - m_new);
      corr_s[r] = corr;
      l_s[r] = l_s[r] * corr + sum;
      m_s[r] = m_new;
    }
  }
}

template <typename TKV, typename TV, int D>
__global__ void __launch_bounds__(kThreads) paged_prefill_kernel(
    const float* __restrict__ q, const TKV* __restrict__ kc, const TKV* __restrict__ vc,
    const unsigned char* __restrict__ codes, const float* __restrict__ rs,
    const float* __restrict__ rz, const float* __restrict__ ts, const float* __restrict__ tz,
    const TV* __restrict__ values, const int* __restrict__ page_row, int n_prefix,
    int chunk_len, float* __restrict__ out, int Hkv, int QT, int Tc, int g, int PP,
    int t_bits) {
  constexpr int P = D / 2;
  constexpr int kCols = D / kTG;          // accumulator columns per thread
  extern __shared__ float smem[];
  const int NT = 1 << t_bits;
  const unsigned tmask = static_cast<unsigned>(NT - 1);
  const int L = max(g, kBK);              // rows of a value tile
  const int ss = L + 1;                   // padded score-row stride
  float* sc = smem;                       // (kBR, ss) scores, then probabilities
  float* v_s = sc + kBR * ss;             // (L, D) value rows of a page / chunk tile
  float* kr_s = v_s + L * D;              // page: rho~ (g, P); chunk: keys (kBK, D)
  const int kr_len = max(g * P, kBK * D);
  float* cos_s = kr_s + kr_len;           // (P, NT)
  float* sin_s = cos_s + P * NT;          // (P, NT)
  float* st = sin_s + P * NT;             // rho scale, rho zero, theta scale, theta zero: (4, P)
  float* m_s = st + 4 * P;                // (kBR,)
  float* l_s = m_s + kBR;
  float* corr_s = l_s + kBR;
  unsigned char* code_s = reinterpret_cast<unsigned char*>(corr_s + kBR);  // (g, P)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row = tid % kBR, tg = tid / kBR;
  const int j = blockIdx.y;
  const int r0 = blockIdx.x * kBR;
  const int rg = r0 + row;
  const bool live_row = rg < QT;
  const int tq = rg % Tc;

  float qr[D];
  {
    const float* qp = q + (static_cast<long long>(j) * QT + (live_row ? rg : 0)) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) qr[c] = live_row ? qp[c] : 0.0f;
  }
  float acc[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) acc[k] = 0.0f;
  for (int i = tid; i < kBR; i += kThreads) {
    m_s[i] = rt::kNegInf;
    l_s[i] = 0.0f;
  }

  // p @ V over the first `nrows` value rows of v_s, after rescaling by corr
  auto accumulate = [&](int nrows) {
    const float corr = corr_s[row];
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[k] *= corr;
    const float* prow = sc + row * ss;
    for (int t = 0; t < nrows; ++t) {
      const float p = prow[t];
      const float* vr = v_s + t * D + tg * kCols;
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc[k] += p * vr[k];
    }
  };

  // ---- 1. the quantized prefix pages ----
  for (int n = 0; n < n_prefix; ++n) {
    const int page = page_row[n];
    const bool valid = page >= 0 && page < PP - 1;   // uniform across the block
    const long long ph = static_cast<long long>(valid ? page : 0) * Hkv + j;
    __syncthreads();  // the previous step's readers are done with the tiles
    for (int i = tid; i < 4 * P; i += kThreads) {
      const int which = i / P, p = i % P;
      const float* src = which == 0 ? rs : which == 1 ? rz : which == 2 ? ts : tz;
      st[i] = valid ? src[ph * P + p] : 0.0f;
    }
    const uint32_t* cpage = reinterpret_cast<const uint32_t*>(codes + ph * g * P);
    for (int i = tid; i < g * P / 4; i += kThreads)
      reinterpret_cast<uint32_t*>(code_s)[i] = valid ? cpage[i] : 0u;
    const TV* vpage = values + ph * g * D;
    for (int i = tid; i < g * D; i += kThreads) v_s[i] = valid ? rt::to_f32(vpage[i]) : 0.0f;
    __syncthreads();
    for (int i = tid; i < P * NT; i += kThreads) {
      const int p = i / NT, a = i % NT;
      const float th = (static_cast<float>(a) + 0.5f) * st[2 * P + p] + st[3 * P + p];
      float sn, cs;
      sincosf(th - rt::kPi, &sn, &cs);
      cos_s[i] = cs;
      sin_s[i] = sn;
    }
    for (int i = tid; i < g * P; i += kThreads) {
      const int p = i % P;
      kr_s[i] = (static_cast<float>(code_s[i] >> t_bits) + 0.5f) * st[p] + st[P + p];
    }
    __syncthreads();
    for (int t = tg; t < g; t += kTG) {
      const unsigned char* crow = code_s + t * P;
      const float* rrow = kr_s + t * P;
      float s = 0.0f;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int e = p * NT + static_cast<int>(crow[p] & tmask);
        s += rrow[p] * (qr[p] * cos_s[e] + qr[P + p] * sin_s[e]);
      }
      sc[row * ss + t] = s;
    }
    __syncthreads();
    online_update(sc, ss, g, m_s, l_s, corr_s, warp, lane);
    __syncthreads();
    accumulate(g);
  }

  // ---- 2. the chunk's own fp causal tile ----
  const int last = min(r0 + kBR, QT) - 1;
  const int tq_max = (last / Tc == r0 / Tc) ? last % Tc : Tc - 1;
  const int kend = min(chunk_len, tq_max + 1);
  const TKV* kb = kc + static_cast<long long>(j) * Tc * D;
  const TKV* vb = vc + static_cast<long long>(j) * Tc * D;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();
    for (int i = tid; i < kBK * D; i += kThreads) {
      const bool live = k0 + i / D < chunk_len;
      const long long off = static_cast<long long>(k0) * D + i;
      kr_s[i] = live ? rt::to_f32(kb[off]) : 0.0f;
      v_s[i] = live ? rt::to_f32(vb[off]) : 0.0f;
    }
    __syncthreads();
    for (int jj = tg; jj < kBK; jj += kTG) {
      const int key = k0 + jj;
      const float* kr = kr_s + jj * D;
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < D; ++c) s += qr[c] * kr[c];
      sc[row * ss + jj] = (key < chunk_len && key <= tq) ? s : rt::kNegInf;
    }
    __syncthreads();
    online_update(sc, ss, kBK, m_s, l_s, corr_s, warp, lane);
    __syncthreads();
    accumulate(kBK);
  }

  __syncthreads();
  if (live_row) {
    const float l = l_s[row];
    const float inv = l == 0.0f ? 1.0f : l;
    float* op = out + (static_cast<long long>(j) * QT + rg) * D + tg * kCols;
#pragma unroll
    for (int k = 0; k < kCols; ++k) op[k] = acc[k] / inv;
  }
}

size_t smem_bytes(int d, int g, int t_bits) {
  const int P = d / 2, NT = 1 << t_bits, L = g > kBK ? g : kBK;
  const int kr_len = g * P > kBK * d ? g * P : kBK * d;
  return sizeof(float) * static_cast<size_t>(kBR * (L + 1) + L * d + kr_len + 2 * P * NT +
                                             4 * P + 3 * kBR) +
         static_cast<size_t>(g * P);
}

template <typename TKV, typename TV, int D>
int launch(const void* q, const void* kc, const void* vc, const void* codes, const void* rs,
           const void* rz, const void* ts, const void* tz, const void* values,
           const void* page_row, int n_prefix, int chunk_len, void* out, int Hkv, int QT, int Tc,
           int g, int PP, int t_bits, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, g, t_bits);
  cudaError_t err = rt::allow_smem(paged_prefill_kernel<TKV, TV, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((QT + kBR - 1) / kBR, Hkv);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  paged_prefill_kernel<TKV, TV, D><<<grid, kThreads, smem, stream>>>(
      f(q), static_cast<const TKV*>(kc), static_cast<const TKV*>(vc),
      static_cast<const unsigned char*>(codes), f(rs), f(rz), f(ts), f(tz),
      static_cast<const TV*>(values), static_cast<const int*>(page_row), n_prefix, chunk_len,
      static_cast<float*>(out), Hkv, QT, Tc, g, PP, t_bits);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV, typename TV>
int launch_d(int d, const void* q, const void* kc, const void* vc, const void* codes,
             const void* rs, const void* rz, const void* ts, const void* tz, const void* values,
             const void* page_row, int n_prefix, int chunk_len, void* out, int Hkv, int QT,
             int Tc, int g, int PP, int t_bits, cudaStream_t s) {
  if (d == 32)
    return launch<TKV, TV, 32>(q, kc, vc, codes, rs, rz, ts, tz, values, page_row, n_prefix,
                               chunk_len, out, Hkv, QT, Tc, g, PP, t_bits, s);
  if (d == 64)
    return launch<TKV, TV, 64>(q, kc, vc, codes, rs, rz, ts, tz, values, page_row, n_prefix,
                               chunk_len, out, Hkv, QT, Tc, g, PP, t_bits, s);
  if (d == 128)
    return launch<TKV, TV, 128>(q, kc, vc, codes, rs, rz, ts, tz, values, page_row, n_prefix,
                                chunk_len, out, Hkv, QT, Tc, g, PP, t_bits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (Hkv, QT, d) fp32 pre-scaled, QT = (Hq/Hkv)*Tc; k_chunk/v_chunk
// (Hkv, Tc, d) bf16 (kv_bf16 = 1) or fp32; pools codes (PP, Hkv, g, d/2)
// uint8, stats (PP, Hkv, 1, d/2) fp32, values (PP, Hkv, g, d) bf16
// (v_bf16 = 1) or fp32; page_row: the first n_prefix = start/g entries of
// the slot's table row. Output (Hkv, QT, d) fp32. d in {32, 64, 128}.
extern "C" int paged_prefill_launch(const void* q, const void* kc, const void* vc, int kv_bf16,
                                    const void* codes, const void* rs, const void* rz,
                                    const void* ts, const void* tz, const void* values,
                                    int v_bf16, const void* page_row, int n_prefix,
                                    int chunk_len, void* out, int Hkv, int QT, int Tc, int d,
                                    int g, int PP, int t_bits, void* stream) {
  if (Hkv <= 0 || Hkv > 65535 || QT <= 0 || Tc <= 0 || QT % Tc || g <= 0 || n_prefix < 0 ||
      chunk_len < 0 || chunk_len > Tc || PP <= 0 || t_bits < 1 || t_bits > 8 ||
      (g * (d / 2)) % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (kv_bf16 && v_bf16)
    return launch_d<bf, bf>(d, q, kc, vc, codes, rs, rz, ts, tz, values, page_row, n_prefix,
                            chunk_len, out, Hkv, QT, Tc, g, PP, t_bits, s);
  if (kv_bf16)
    return launch_d<bf, float>(d, q, kc, vc, codes, rs, rz, ts, tz, values, page_row, n_prefix,
                               chunk_len, out, Hkv, QT, Tc, g, PP, t_bits, s);
  if (v_bf16)
    return launch_d<float, bf>(d, q, kc, vc, codes, rs, rz, ts, tz, values, page_row, n_prefix,
                               chunk_len, out, Hkv, QT, Tc, g, PP, t_bits, s);
  return launch_d<float, float>(d, q, kc, vc, codes, rs, rz, ts, tz, values, page_row, n_prefix,
                                chunk_len, out, Hkv, QT, Tc, g, PP, t_bits, s);
}
