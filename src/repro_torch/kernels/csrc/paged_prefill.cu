// Page-native fused PolarQuant chunk-prefill attention (replaces the
// Pallas kernel repro/kernels/paged_prefill.py::polar_paged_prefill_grouped).
//
// One prefill chunk of Tc tokens attends to the slot's quantized prefix
// pages [0, start) and, causally, to its own fp keys. The chunk's queries
// arrive folded onto the head axis: per kv head j one tall operand of
// QT = (Hq/Hkv)*Tc pre-scaled fp32 rows, row = qh*Tc + t. Every row's
// softmax lives in one block, so no cross-block merge is needed. The
// output is acc / l (l == 0 keeps fully masked rows finite), fp32
// (Hkv, QT, d). A page id outside [0, PP - 1) — the scratch page — reads
// as zero codes, stats and values, as the plain version gathers it; key
// and value rows past chunk_len read as zeros, so NaN there never reaches
// a sum.
//
// Bound: operations. At start = 1024, Tc = 256 (4 kv heads x 8 q heads)
// the least work is the two products q.k~ over the prefix and q.k over
// the causal chunk, and both p.V: ~2.4 GFLOP, ~2.4 us at the 989 TFLOP/s
// bf16 tensor-core peak, above the ~0.6 us of fp32 dequantization and
// softmax and the ~1.5 us that ~5.1 MB take at 3.35 TB/s (chip_smoke.py
// computes it from its inputs). Two bodies, chosen by the launch
// (paged_prefill_tensor_core):
//
// Tensor cores (bf16 chunk K/V and bf16 value pool, d in {32, 64, 128},
// g in {64, 128}, t <= 4 bits, 16-byte aligned buffers: the served path).
// For prefill the LUT does not pay: QT rows share every page, and the
// LUT score sum_p rho~ (q_x cos(th~ - pi) + q_y sin(th~ - pi)) is exactly
// q . k~ with k~ the page's dequantized key. Grid (Hkv, QT / 64), 8 warps:
// two key groups of 4 warps x 16 query rows, each group scoring its half
// of every 128-key stage with its own softmax carry, merged at the end
// (the grid is only 128 blocks, so a second group fills SM warp slots
// that a second block could not); the 64-row tiles that reach furthest
// into the causal chunk launch first. Per block the stages are the live
// prefix pages, then the chunk's 128-key stages up to the block's last
// t_q; each stage's codes, stats and bf16 value rows (or chunk K/V rows)
// arrive by 16-byte cp.async in one of two buffers, so stage n+1 is in
// flight while stage n is computed. A page is dequantized once per block
// (cos/sin of its 2^t angle states, then k~ = rho~ (cos, sin)) into
// shared memory as bf16 hi/lo pairs; S = Q k~^T and O += P V are mma.sync
// m16n8k16 bf16 products
// with fp32 accumulators and the online softmax in registers (the
// fragment layout of flash_prefill.cu, helpers in mma.cuh). Precision:
// an fp32 operand x enters the tensor cores as hi = bf16(x) plus
// lo = bf16(x - hi), equal to x within 2^-18 |x|. Q (fp32) and k~ (fp32)
// take three products (hi.hi + hi.lo + lo.hi: the dropped lo.lo is below
// 2^-18 of the product); chunk K and the value rows are bf16 and exact,
// so q.k and P.V (P fp32, split) take two. Each product carries a
// relative error below ~3 * 2^-18 ~ 1.1e-5, summed in fp32: the 1e-4
// checks of the FMA body hold unchanged.
//
// uint8 value pools (codes with one fp32 scale and zero per row: the TPU
// kernel's uint8 branch, repro/kernels/paged_prefill.py:103) take the
// tensor-core body under the same conditions. A page's codes arrive by
// cp.async with its scales and zeros and are widened to bf16 (codes up to
// 255 are exact in bf16) as the B operand of P.V; P's columns are scaled
// by the rows' scales before the hi/lo split, and each query row adds
// sum_t p_t z_t: sum_t p_t (c_t s_t + z_t) = sum_t (p_t s_t) c_t +
// sum_t p_t z_t. The chunk's own K/V rows stay bf16.
//
// FMA body (fp32 chunk K/V or fp32 value pool — the tests' fp32 inputs —
// and any shape outside the above): the first version; uint8 value rows
// are dequantized as a page is staged. Thread
// tid owns query row tid % 64 (q in registers) and a quarter of the tokens
// or of the d columns; per page it stages stats, codes and values in
// shared memory, builds cos/sin of the angle states and rho~, and scores
// by gather; the chunk tile in 64-key steps; plain fp32 FMAs throughout.
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

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
    const TV* __restrict__ values, const float* __restrict__ vscale,
    const float* __restrict__ vzero, const int* __restrict__ page_row, int n_prefix,
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
    for (int i = tid; i < g * D; i += kThreads) {
      float v = 0.0f;
      if (valid) {
        v = rt::to_f32(vpage[i]);
        if constexpr (rt::kQuantV<TV>) v = fmaf(v, vscale[ph * g + i / D], vzero[ph * g + i / D]);
      }
      v_s[i] = v;
    }
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
           const void* vscale, const void* vzero, const void* page_row, int n_prefix,
           int chunk_len, void* out, int Hkv, int QT, int Tc, int g, int PP, int t_bits,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D, g, t_bits);
  cudaError_t err = rt::allow_smem(paged_prefill_kernel<TKV, TV, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((QT + kBR - 1) / kBR, Hkv);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  paged_prefill_kernel<TKV, TV, D><<<grid, kThreads, smem, stream>>>(
      f(q), static_cast<const TKV*>(kc), static_cast<const TKV*>(vc),
      static_cast<const unsigned char*>(codes), f(rs), f(rz), f(ts), f(tz),
      static_cast<const TV*>(values), f(vscale), f(vzero), static_cast<const int*>(page_row),
      n_prefix, chunk_len, static_cast<float*>(out), Hkv, QT, Tc, g, PP, t_bits);
  return static_cast<int>(cudaGetLastError());
}

template <typename TKV, typename TV>
int launch_d(int d, const void* q, const void* kc, const void* vc, const void* codes,
             const void* rs, const void* rz, const void* ts, const void* tz, const void* values,
             const void* vscale, const void* vzero, const void* page_row, int n_prefix,
             int chunk_len, void* out, int Hkv, int QT, int Tc, int g, int PP, int t_bits,
             cudaStream_t s) {
  if (d == 32)
    return launch<TKV, TV, 32>(q, kc, vc, codes, rs, rz, ts, tz, values, vscale, vzero,
                               page_row, n_prefix, chunk_len, out, Hkv, QT, Tc, g, PP, t_bits,
                               s);
  if (d == 64)
    return launch<TKV, TV, 64>(q, kc, vc, codes, rs, rz, ts, tz, values, vscale, vzero,
                               page_row, n_prefix, chunk_len, out, Hkv, QT, Tc, g, PP, t_bits,
                               s);
  if (d == 128)
    return launch<TKV, TV, 128>(q, kc, vc, codes, rs, rz, ts, tz, values, vscale, vzero,
                                page_row, n_prefix, chunk_len, out, Hkv, QT, Tc, g, PP, t_bits,
                                s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// tensor-core body
// ---------------------------------------------------------------------------

constexpr int kKeyGroups = 2;                  // warp groups that split a stage's keys
constexpr int kMmaThreads = 128 * kKeyGroups;  // per group 4 warps x 16 query rows
constexpr int kMmaRows = 64;                   // query rows per block
constexpr int kKeys = 64;                      // keys per score tile
constexpr int kStageKeys = kKeys * kKeyGroups;  // chunk keys per stage
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the tensor-core body, in bytes: k~ hi and lo
// (g, d + 8) bf16, the (P, 2^t) cos/sin table as float2, then two stage
// buffers, each the value or chunk-V rows (max(g, kStageKeys), d + 8)
// bf16 and a raw area holding a page's codes (g, P) and stats (4, P) —
// with uint8 values also the page's value codes (g, d) and their scales
// and zeros (2, g) fp32 — or a chunk stage's K rows (kStageKeys, d + 8)
// bf16. Rows are padded by 16 bytes, so the 8 rows of an ldmatrix land in
// distinct banks. After the walk the stage buffers carry the key groups'
// partials to group 0.
struct MmaSmem {
  int kpad, vbytes, rawbytes, lut, stages;
  __host__ __device__ MmaSmem(int d, int g, int t_bits, bool quant) {
    const int P = d / 2;
    kpad = d + 8;
    vbytes = (g > kStageKeys ? g : kStageKeys) * kpad * 2;
    const int page = g * P + 16 * P + (quant ? g * d + 8 * g : 0);
    rawbytes = page > kStageKeys * kpad * 2 ? page : kStageKeys * kpad * 2;
    lut = 2 * g * kpad * 2;
    stages = lut + P * (1 << t_bits) * 8;
  }
  size_t bytes() const { return static_cast<size_t>(stages) + 2 * (vbytes + rawbytes); }
};

// One 64-key tile for one warp's 16 query rows: S = Q K^T (Q hi and lo
// against K hi, plus Q hi against K lo when kLo), the chunk's causal mask
// when kMask, the online softmax in registers (m in raw-score units,
// exponentials in base 2) and O += P V with P split into hi and lo.
// kt / klt / vt point at the tile's first key row (row stride D + 8).
// kQuant: vt holds uint8 value codes as bf16 and vsc / vze the tile's row
// scales and zeros; P's columns are scaled by vsc before the split and
// every row adds sum_t p_t vze_t.
template <int D, bool kLo, bool kMask, bool kQuant = false>
__device__ __forceinline__ void mma_tile(const unsigned (&qh)[D / 16][4],
                                         const unsigned (&ql)[D / 16][4],
                                         const __nv_bfloat16* kt, const __nv_bfloat16* klt,
                                         const __nv_bfloat16* vt, float (&o)[D / 8][4],
                                         float (&m_r)[2], float (&l_r)[2], int k0, int chunk_len,
                                         const int (&tq_r)[2], const float* vsc = nullptr,
                                         const float* vze = nullptr) {
  constexpr int kS = D + 8, kKD = D / 16, kND = D / 8, kNK = kKeys / 8;
  const int lane = threadIdx.x % 32, tq = lane & 3;
  float s[kNK][4];
#pragma unroll
  for (int n = 0; n < kNK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < kKD; ++kk) {
#pragma unroll
    for (int n2 = 0; n2 < kNK / 2; ++n2) {
      const int off = (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * kS + kk * 16 +
                      ((lane >> 3) & 1) * 8;
      unsigned bh[4];
      ldmatrix_x4(bh, kt + off);
      // the small terms first
      mma_bf16(s[2 * n2], ql[kk], bh[0], bh[1]);
      mma_bf16(s[2 * n2 + 1], ql[kk], bh[2], bh[3]);
      if (kLo) {
        unsigned bl[4];
        ldmatrix_x4(bl, klt + off);
        mma_bf16(s[2 * n2], qh[kk], bl[0], bl[1]);
        mma_bf16(s[2 * n2 + 1], qh[kk], bl[2], bl[3]);
      }
      mma_bf16(s[2 * n2], qh[kk], bh[0], bh[1]);
      mma_bf16(s[2 * n2 + 1], qh[kk], bh[2], bh[3]);
    }
  }
  if (kMask) {  // keep t_k < chunk_len and t_k <= t_q
#pragma unroll
    for (int n = 0; n < kNK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = k0 + n * 8 + 2 * tq + (e & 1);
        if (kj >= chunk_len || kj > tq_r[e >> 1]) s[n][e] = -INFINITY;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m_r[r];
#pragma unroll
    for (int n = 0; n < kNK; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
    mx = quad_max(mx);
    const float base = mx == -INFINITY ? 0.0f : mx * kLog2e;
    const float corr = ex2(m_r[r] * kLog2e - base);
    m_r[r] = mx;
    float sum = 0.0f;
#pragma unroll
    for (int n = 0; n < kNK; ++n) {
      s[n][2 * r] = ex2(fmaf(s[n][2 * r], kLog2e, -base));
      s[n][2 * r + 1] = ex2(fmaf(s[n][2 * r + 1], kLog2e, -base));
      sum += s[n][2 * r] + s[n][2 * r + 1];
    }
    l_r[r] = l_r[r] * corr + sum;
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      o[n][2 * r] *= corr;
      o[n][2 * r + 1] *= corr;
    }
    if constexpr (kQuant) {  // p_t s_t for P.codes; the row's sum_t p_t z_t into O
      float pz = 0.0f;
#pragma unroll
      for (int n = 0; n < kNK; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kj = n * 8 + 2 * tq + e;
          pz += s[n][2 * r + e] * vze[kj];
          s[n][2 * r + e] *= vsc[kj];
        }
      pz = quad_sum(pz);
#pragma unroll
      for (int n = 0; n < kND; ++n) {
        o[n][2 * r] += pz;
        o[n][2 * r + 1] += pz;
      }
    }
  }
  // O += P V: P hi and lo (registers) as A operands, 16 keys per k step
#pragma unroll
  for (int kk = 0; kk < kNK / 2; ++kk) {
    unsigned ph[4], pl[4];
    split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
    split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
    split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
    split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
    for (int n2 = 0; n2 < kND / 2; ++n2) {
      unsigned bv[4];
      ldmatrix_x4_trans(bv, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kS +
                                n2 * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * n2], pl, bv[0], bv[1]);
      mma_bf16(o[2 * n2 + 1], pl, bv[2], bv[3]);
      mma_bf16(o[2 * n2], ph, bv[0], bv[1]);
      mma_bf16(o[2 * n2 + 1], ph, bv[2], bv[3]);
    }
  }
}

// the largest t_q among rows [r0, r0 + n) (clipped to QT) of the folded q
__device__ __forceinline__ int max_tq(int r0, int n, int QT, int Tc) {
  const int last = min(r0 + n, QT) - 1;
  return (last / Tc == r0 / Tc) ? last % Tc : Tc - 1;
}

// Grid (Hkv, ceil(QT / 64)); lane = 4 * gid + tq, fragments as in
// flash_prefill.cu. blockIdx.y = 0 is a tile that reaches furthest into
// the causal chunk. Warp w owns query rows 16 (w % 4) of the tile and key
// group w / 4: of each 128-key page or chunk stage, group k scores keys
// [64 k, 64 k + 64) with its own softmax carry, and group 0 merges the
// carries at the end (128 blocks of 8 warps, where one group of 4 warps
// left most of each SM's warp slots empty).
// TV: the value pool's rows, bf16 or uint8 codes (with vscale / vzero).
template <int D, typename TV>
__global__ void __launch_bounds__(kMmaThreads, 2 / kKeyGroups) paged_prefill_mma_kernel(
    const float* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, const unsigned char* __restrict__ codes,
    const float* __restrict__ rs, const float* __restrict__ rz, const float* __restrict__ ts,
    const float* __restrict__ tz, const TV* __restrict__ values,
    const float* __restrict__ vscale, const float* __restrict__ vzero,
    const int* __restrict__ page_row, int n_prefix, int chunk_len, float* __restrict__ out,
    int Hkv, int QT, int Tc, int g, int PP, int t_bits) {
  constexpr int P = D / 2, kS = D + 8, kKD = D / 16, kND = D / 8, kRowChunks = D / 8;
  constexpr bool kQ = rt::kQuantV<TV>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MmaSmem lay(D, g, t_bits, kQ);
  const int NT = 1 << t_bits;
  const unsigned tmask = static_cast<unsigned>(NT - 1);
  auto* khi = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* klo = khi + g * kS;
  auto* lut = reinterpret_cast<float2*>(smem_raw + lay.lut);
  const int stage_bytes = lay.vbytes + lay.rawbytes;
  auto vrows = [&](int b) {
    return reinterpret_cast<__nv_bfloat16*>(smem_raw + lay.stages + b * stage_bytes);
  };
  auto raw = [&](int b) { return smem_raw + lay.stages + b * stage_bytes + lay.vbytes; };
  // uint8 values: a page's value codes (g, D) and scales / zeros (2, g) in
  // the raw area, after its key codes and stats
  auto vcodes = [&](int b) { return raw(b) + g * P + 16 * P; };
  auto vsz = [&](int b) { return reinterpret_cast<float*>(vcodes(b) + g * D); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tq = lane & 3;
  const int rw = warp % 4, kg = warp / 4;  // row group, key group
  const int j = blockIdx.x;
  int tile = gridDim.y - 1 - blockIdx.y;
  if (Tc % kMmaRows == 0) {  // every query head's last tile first
    const int per_q = Tc / kMmaRows, nq = QT / Tc;
    tile = (blockIdx.y % nq) * per_q + (per_q - 1 - blockIdx.y / nq);
  }
  const int r0 = tile * kMmaRows;
  const int row0 = r0 + rw * 16;  // the warp's first query row
  const int tq_r[2] = {(row0 + gid) % Tc, (row0 + gid + 8) % Tc};

  // q rows -> hi/lo A fragments, held for the whole walk (rows past QT zero)
  unsigned qh[kKD][4], ql[kKD][4];
  {
    const float* qb = q + static_cast<long long>(j) * QT * D;
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + gid + (e & 1) * 8, c = kk * 16 + (e >> 1) * 8 + 2 * tq;
        const float2 x = r < QT ? *reinterpret_cast<const float2*>(
                                      qb + static_cast<long long>(r) * D + c)
                                : make_float2(0.0f, 0.0f);
        split_bf16(x.x, x.y, qh[kk][e], ql[kk][e]);
      }
  }

  const __nv_bfloat16* kb = kc + static_cast<long long>(j) * Tc * D;
  const __nv_bfloat16* vb = vc + static_cast<long long>(j) * Tc * D;
  // stage i into buffer b: prefix page i (codes, stats, value rows) or
  // chunk tile i - n_prefix (K and V rows, zeros at and past chunk_len)
  auto stage = [&](int i, int b) {
    __nv_bfloat16* vd = vrows(b);
    if (i < n_prefix) {
      const int page = page_row[i];
      const bool valid = page >= 0 && page < PP - 1;  // else zeros (scratch)
      const long long ph = static_cast<long long>(valid ? page : 0) * Hkv + j;
      unsigned char* cd = raw(b);
      const unsigned char* cs = codes + ph * g * P;
      for (int c = tid; c < g * P / 16; c += kMmaThreads)
        cp_async16(cd + c * 16, cs + c * 16, valid);
      auto* st = reinterpret_cast<float*>(cd + g * P);
      for (int c = tid; c < P; c += kMmaThreads) {  // 4 stat rows of P/4 chunks
        const int which = c / (P / 4), off = (c % (P / 4)) * 4;
        const float* src = which == 0 ? rs : which == 1 ? rz : which == 2 ? ts : tz;
        cp_async16(st + which * P + off, src + ph * P + off, valid);
      }
      if constexpr (kQ) {
        const unsigned char* vs = values + ph * g * D;
        unsigned char* vq = vcodes(b);
        for (int c = tid; c < g * D / 16; c += kMmaThreads)
          cp_async16(vq + c * 16, vs + c * 16, valid);
        float* sz = vsz(b);
        for (int c = tid; c < g / 2; c += kMmaThreads) {  // g/4 chunks each
          const int which = c / (g / 4), off = (c % (g / 4)) * 4;
          cp_async16(sz + which * g + off, (which ? vzero : vscale) + ph * g + off, valid);
        }
      } else {
        const __nv_bfloat16* vs = values + ph * g * D;
        for (int c = tid; c < g * kRowChunks; c += kMmaThreads) {
          const int r = c / kRowChunks, col = (c % kRowChunks) * 8;
          cp_async16(vd + r * kS + col, vs + r * D + col, valid);
        }
      }
    } else {
      const int k0 = (i - n_prefix) * kStageKeys;
      auto* kd = reinterpret_cast<__nv_bfloat16*>(raw(b));
      for (int c = tid; c < kStageKeys * kRowChunks; c += kMmaThreads) {
        const int r = c / kRowChunks, col = (c % kRowChunks) * 8;
        const bool ok = k0 + r < chunk_len;
        const long long off = ok ? static_cast<long long>(k0 + r) * D + col : 0;
        cp_async16(kd + r * kS + col, kb + off, ok);
        cp_async16(vd + r * kS + col, vb + off, ok);
      }
    }
  };

  const int kend = min(chunk_len, max_tq(r0, kMmaRows, QT, Tc) + 1);
  const int n_stages = n_prefix + (kend + kStageKeys - 1) / kStageKeys;
  const int warp_tq_max = row0 < QT ? max_tq(row0, 16, QT, Tc) : -1;

  float o[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_r[2] = {-INFINITY, -INFINITY};  // raw-score row max, rows gid and gid+8
  float l_r[2] = {0.0f, 0.0f};            // this thread's share of the row sums

  if (n_stages > 0) {
    stage(0, 0);
    cp_async_commit();
  }
  for (int i = 0; i < n_stages; ++i) {
    const int b = i & 1;
    if (i + 1 < n_stages) {
      stage(i + 1, b ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (i < n_prefix) {
      // dequantize the page once for the block: cos/sin of its angle
      // states, then k~ = rho~ (cos(th~ - pi), sin(th~ - pi)) as bf16 hi/lo
      const unsigned char* cd = raw(b);
      const auto* st = reinterpret_cast<const float*>(cd + g * P);
      for (int e = tid; e < P * NT; e += kMmaThreads) {
        const int p = e >> t_bits, a = e & (NT - 1);
        const float th = (static_cast<float>(a) + 0.5f) * st[2 * P + p] + st[3 * P + p];
        float sn, cs;
        sincosf(th - rt::kPi, &sn, &cs);
        lut[e] = make_float2(cs, sn);
      }
      __syncthreads();
      for (int e = tid; e < g * (P / 2); e += kMmaThreads) {
        const int t = e / (P / 2), p = (e % (P / 2)) * 2;
        const unsigned c0 = cd[t * P + p], c1 = cd[t * P + p + 1];
        const float rho0 = (static_cast<float>(c0 >> t_bits) + 0.5f) * st[p] + st[P + p];
        const float rho1 =
            (static_cast<float>(c1 >> t_bits) + 0.5f) * st[p + 1] + st[P + p + 1];
        const float2 a0 = lut[p * NT + (c0 & tmask)];
        const float2 a1 = lut[(p + 1) * NT + (c1 & tmask)];
        unsigned hi, lo;
        split_bf16(rho0 * a0.x, rho1 * a1.x, hi, lo);
        *reinterpret_cast<unsigned*>(khi + t * kS + p) = hi;
        *reinterpret_cast<unsigned*>(klo + t * kS + p) = lo;
        split_bf16(rho0 * a0.y, rho1 * a1.y, hi, lo);
        *reinterpret_cast<unsigned*>(khi + t * kS + P + p) = hi;
        *reinterpret_cast<unsigned*>(klo + t * kS + P + p) = lo;
      }
      if constexpr (kQ) {  // value codes -> bf16 rows (exact: codes <= 255)
        const unsigned char* vq = vcodes(b);
        __nv_bfloat16* vd = vrows(b);
        for (int e = tid; e < g * (D / 4); e += kMmaThreads) {
          const int t = e / (D / 4), c = (e % (D / 4)) * 4;
          const unsigned w = *reinterpret_cast<const unsigned*>(vq + t * D + c);
          *reinterpret_cast<uint2*>(vd + t * kS + c) =
              make_uint2(pack_bf16(static_cast<float>(w & 0xffu),
                                   static_cast<float>((w >> 8) & 0xffu)),
                         pack_bf16(static_cast<float>((w >> 16) & 0xffu),
                                   static_cast<float>(w >> 24)));
        }
      }
      __syncthreads();
      const float* sz = vsz(b);
      for (int k0 = kg * kKeys; k0 < g; k0 += kStageKeys)
        mma_tile<D, true, false, kQ>(qh, ql, khi + k0 * kS, klo + k0 * kS, vrows(b) + k0 * kS,
                                     o, m_r, l_r, 0, 0, tq_r, sz + k0, sz + g + k0);
    } else {
      const int k0 = (i - n_prefix) * kStageKeys + kg * kKeys;
      // a tile past chunk_len or wholly above the warp's diagonal is skipped
      if (k0 < kend && k0 <= warp_tq_max)
        mma_tile<D, false, true>(
            qh, ql, reinterpret_cast<const __nv_bfloat16*>(raw(b)) + kg * kKeys * kS, nullptr,
            vrows(b) + kg * kKeys * kS, o, m_r, l_r, k0, chunk_len, tq_r);
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  // merge the key groups' carries into group 0, lane by lane (the
  // partner thread of group k holds the same rows and columns)
  constexpr int kX = kND * 4 + 4;
  auto* xs = reinterpret_cast<float*>(smem_raw + lay.stages) + (rw * 32 + lane) * kX;
  for (int grp = 1; grp < kKeyGroups; ++grp) {
    if (kg == grp) {
#pragma unroll
      for (int n = 0; n < kND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) xs[n * 4 + e] = o[n][e];
      xs[kND * 4] = m_r[0];
      xs[kND * 4 + 1] = m_r[1];
      xs[kND * 4 + 2] = l_r[0];
      xs[kND * 4 + 3] = l_r[1];
    }
    __syncthreads();
    if (kg == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = xs[kND * 4 + r], mx = fmaxf(m_r[r], m1);
        const float base = mx == -INFINITY ? 0.0f : mx * kLog2e;
        const float c0 = ex2(m_r[r] * kLog2e - base), c1 = ex2(m1 * kLog2e - base);
        m_r[r] = mx;
        l_r[r] = l_r[r] * c0 + xs[kND * 4 + 2 + r] * c1;
#pragma unroll
        for (int n = 0; n < kND; ++n) {
          o[n][2 * r] = o[n][2 * r] * c0 + xs[n * 4 + 2 * r] * c1;
          o[n][2 * r + 1] = o[n][2 * r + 1] * c0 + xs[n * 4 + 2 * r + 1] * c1;
        }
      }
    }
    __syncthreads();
  }
  if (kg != 0) return;

  float* ob = out + static_cast<long long>(j) * QT * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_r[r]);
    const float inv = l == 0.0f ? 1.0f : l;
    const int row = row0 + gid + r * 8;
    if (row < QT) {
      float* orow = ob + static_cast<long long>(row) * D;
#pragma unroll
      for (int n = 0; n < kND; ++n)
        *reinterpret_cast<float2*>(orow + n * 8 + 2 * tq) =
            make_float2(o[n][2 * r] / inv, o[n][2 * r + 1] / inv);
    }
  }
}

template <int D, typename TV>
int launch_mma(const void* q, const void* kc, const void* vc, const void* codes, const void* rs,
               const void* rz, const void* ts, const void* tz, const void* values,
               const void* vscale, const void* vzero, const void* page_row, int n_prefix,
               int chunk_len, void* out, int Hkv, int QT, int Tc, int g, int PP, int t_bits,
               cudaStream_t stream) {
  const size_t smem = MmaSmem(D, g, t_bits, rt::kQuantV<TV>).bytes();
  cudaError_t err = rt::allow_smem(paged_prefill_mma_kernel<D, TV>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Hkv, (QT + kMmaRows - 1) / kMmaRows);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto bf = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  paged_prefill_mma_kernel<D, TV><<<grid, kMmaThreads, smem, stream>>>(
      f(q), bf(kc), bf(vc), static_cast<const unsigned char*>(codes), f(rs), f(rz), f(ts),
      f(tz), static_cast<const TV*>(values), f(vscale), f(vzero),
      static_cast<const int*>(page_row), n_prefix, chunk_len, static_cast<float*>(out), Hkv,
      QT, Tc, g, PP, t_bits);
  return static_cast<int>(cudaGetLastError());
}

template <typename TV>
int launch_mma_d(int d, const void* q, const void* kc, const void* vc, const void* codes,
                 const void* rs, const void* rz, const void* ts, const void* tz,
                 const void* values, const void* vscale, const void* vzero,
                 const void* page_row, int n_prefix, int chunk_len, void* out, int Hkv, int QT,
                 int Tc, int g, int PP, int t_bits, cudaStream_t s) {
  if (d == 32)
    return launch_mma<32, TV>(q, kc, vc, codes, rs, rz, ts, tz, values, vscale, vzero,
                              page_row, n_prefix, chunk_len, out, Hkv, QT, Tc, g, PP, t_bits, s);
  if (d == 64)
    return launch_mma<64, TV>(q, kc, vc, codes, rs, rz, ts, tz, values, vscale, vzero,
                              page_row, n_prefix, chunk_len, out, Hkv, QT, Tc, g, PP, t_bits, s);
  return launch_mma<128, TV>(q, kc, vc, codes, rs, rz, ts, tz, values, vscale, vzero, page_row,
                             n_prefix, chunk_len, out, Hkv, QT, Tc, g, PP, t_bits, s);
}

}  // namespace

// 1 when paged_prefill_launch runs the tensor-core body for these inputs —
// bf16 chunk K/V, a bf16 or uint8 value pool, d in {32, 64, 128}, g in
// {64, 128}, t_bits <= 4, every buffer that cp.async reads 16-byte
// aligned — else 0 (the FMA body).
extern "C" int paged_prefill_tensor_core(int kv_bf16, int v_kind, int d, int g, int t_bits,
                                         const void* kc, const void* vc, const void* codes,
                                         const void* rs, const void* rz, const void* ts,
                                         const void* tz, const void* values,
                                         const void* vscale, const void* vzero) {
  const bool quant = v_kind == rt::kValueU8;
  return kv_bf16 && (v_kind == rt::kValueBF16 || quant) && (d == 32 || d == 64 || d == 128) &&
         (g == 64 || g == 128) && t_bits <= 4 && aligned16(kc) && aligned16(vc) &&
         aligned16(codes) && aligned16(rs) && aligned16(rz) && aligned16(ts) &&
         aligned16(tz) && aligned16(values) &&
         (!quant || (aligned16(vscale) && aligned16(vzero)));
}

// q (Hkv, QT, d) fp32 pre-scaled, QT = (Hq/Hkv)*Tc; k_chunk/v_chunk
// (Hkv, Tc, d) bf16 (kv_bf16 = 1) or fp32; pools codes (PP, Hkv, g, d/2)
// uint8, stats (PP, Hkv, 1, d/2) fp32, values (PP, Hkv, g, d) of v_kind
// (rt::ValueKind: fp32, bf16, or uint8 with vscale / vzero (PP, Hkv, g, 1)
// fp32; null otherwise); page_row: the first n_prefix = start/g entries of
// the slot's table row. Output (Hkv, QT, d) fp32. d in {32, 64, 128}; the
// body is the tensor-core one where paged_prefill_tensor_core says so.
extern "C" int paged_prefill_launch(const void* q, const void* kc, const void* vc, int kv_bf16,
                                    const void* codes, const void* rs, const void* rz,
                                    const void* ts, const void* tz, const void* values,
                                    int v_kind, const void* vscale, const void* vzero,
                                    const void* page_row, int n_prefix,
                                    int chunk_len, void* out, int Hkv, int QT, int Tc, int d,
                                    int g, int PP, int t_bits, void* stream) {
  if (Hkv <= 0 || Hkv > 65535 || QT <= 0 || Tc <= 0 || QT % Tc || g <= 0 || n_prefix < 0 ||
      chunk_len < 0 || chunk_len > Tc || PP <= 0 || t_bits < 1 || t_bits > 8 ||
      (g * (d / 2)) % 4 ||
      (v_kind == rt::kValueU8 && (vscale == nullptr || vzero == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  const bool mma = paged_prefill_tensor_core(kv_bf16, v_kind, d, g, t_bits, kc, vc, codes, rs,
                                             rz, ts, tz, values, vscale, vzero);
  return rt::with_value_type(v_kind, [&](auto tv) {
    using TV = decltype(tv);
    if constexpr (!std::is_same_v<TV, float>) {
      if (mma)
        return launch_mma_d<TV>(d, q, kc, vc, codes, rs, rz, ts, tz, values, vscale, vzero,
                                page_row, n_prefix, chunk_len, out, Hkv, QT, Tc, g, PP, t_bits,
                                s);
    }
    if (kv_bf16)
      return launch_d<bf, TV>(d, q, kc, vc, codes, rs, rz, ts, tz, values, vscale, vzero,
                              page_row, n_prefix, chunk_len, out, Hkv, QT, Tc, g, PP, t_bits, s);
    return launch_d<float, TV>(d, q, kc, vc, codes, rs, rz, ts, tz, values, vscale, vzero,
                               page_row, n_prefix, chunk_len, out, Hkv, QT, Tc, g, PP, t_bits, s);
  });
}
