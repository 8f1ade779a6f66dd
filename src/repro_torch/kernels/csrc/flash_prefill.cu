// GQA flash attention forward for whole-prompt prefill (replaces the
// Pallas kernel repro/kernels/flash_prefill.py::flash_prefill; the JAX
// serving path computes the same function with the jnp
// core/attention.flash_attention, in its causal, prefix and local modes).
//
// Mask modes (Mask below, as core/attention.py::_mask_bias): full; causal;
// prefix — key j is visible to query i when j <= i or j < prefix_len[b]
// (PaliGemma's image + prefix text); local — i - window < j <= i
// (RecurrentGemma's sliding window). Both bodies walk only the key tiles
// the mode can reach: from the window's first tile (local; a local
// prefill is O(T * window)) to the diagonal (causal, local), to
// max(diagonal, prefix_len[b]) (prefix) or to the end (full).
//
// With a non-null lse pointer each row also writes the log-sum-exp of its
// scaled scores, m + log(l) from its running max and sum (fp32, (B, H,
// Tq)): the forward of the training path's differentiable flash attention
// (core/attention.py::flash_attention), whose backward recomputes the
// probabilities from it. With null nothing else changes.
//
// Bound: operations — ~4*Tq*Tk/2*d FLOPs per head against O(T*d) bytes.
// Two bodies, chosen by dtype:
//
// bf16 (every served path): a FlashAttention-2 style tensor-core kernel.
// One block of 4 warps per (q tile of 64 rows, head h, batch b), 16 rows
// per warp; kv head h / (H/Hkv). The Q tile comes into shared memory once
// and into registers with ldmatrix, where it stays for the whole k loop.
// K/V tiles of 64 keys arrive with 16-byte cp.async copies into two
// buffers, so tile j+1 loads while tile j is computed; rows are padded by
// 16 bytes, which makes the 8 rows of every ldmatrix land in distinct
// banks. S = Q K^T and O += P V are mma.sync m16n8k16 bf16 products with
// fp32 accumulators in registers, V's fragments from ldmatrix.trans. The
// online softmax stays in registers (row max and sum over the 4 lanes of
// a quad, ex2 with log2(e) folded into the scale); P is rounded to bf16
// in registers and fed straight back as the A operand of P V. Only the
// tiles that cross the diagonal, kv_len or the window's lower edge are
// masked; rows past Tq are computed from zero-filled Q rows and never
// written. A row whose every key is masked ends with l == 0 and is written
// as zeros. The q tiles are launched heaviest (last) first, so the causal
// imbalance leaves no tail on 132 SMs. At D = 256 the Q fragments (64
// registers a thread) do not stay in registers beside the 128 of the
// output accumulator: they are reread from the Q tile in shared memory
// with ldmatrix at each k step, and the block takes the SM alone (169 KB
// of shared memory). Pointers that are not 16-byte aligned (cp.async
// needs it) take the fp32-FMA body.
//
// fp32 (the kernel checks and the fp32 smoke config, held to 1e-4): the
// first version's body, unchanged — Q tile, K/V tile, score tile and
// softmax carry in shared memory, plain fp32 FMAs. TF32 tensor cores keep
// a 10-bit mantissa and would not hold 1e-4, so fp32 stays off them.
#include <cstdint>

#include "mma.cuh"

namespace {

// mask modes, in the order of core/attention.py::MASK_MODES
constexpr int kFull = 0, kCausal = 1, kPrefix = 2, kLocal = 3;

// One batch row's mask: the keys a query sees, and the key range a q
// tile [q0, q0 + rows) can reach. Every mode leaves query qi one run of
// keys [lo, hi]: [0, qi] (causal), [0, max(qi, prefix_len - 1)]
// (prefix: j <= i or j < prefix_len), [qi - window + 1, qi] (local),
// [0, kv_len - 1] (full), cut at kv_len - 1; so a thread bounds its rows
// once and tests each key with two compares, as the causal-only kernel
// did.
struct Mask {
  int mode, window, plen;  // plen: prefix_len[b] (prefix mode), else 0

  __device__ __forceinline__ int2 keys(int qi, int kv_len) const {
    const int lo = mode == kLocal ? qi - window + 1 : 0;
    const int hi = mode == kFull ? kv_len - 1 : mode == kPrefix ? max(qi, plen - 1) : qi;
    return make_int2(lo, min(hi, kv_len - 1));
  }
  // first key tile (of `tile` keys) any row of the q tile can see
  __device__ __forceinline__ int k_begin(int q0, int tile) const {
    return mode == kLocal ? max(0, q0 - window + 1) / tile * tile : 0;
  }
  // keys past the last one any row of the q tile can see
  __device__ __forceinline__ int k_end(int q0, int rows, int kv_len) const {
    if (mode == kFull) return kv_len;
    if (mode == kPrefix) return min(kv_len, max(q0 + rows, plen));
    return min(kv_len, q0 + rows);
  }
  // whether a tile of keys [k0, k0 + tile) may hold a masked key for some
  // row of [r0, r0 + rows)
  __device__ __forceinline__ bool partial(int k0, int tile, int r0, int rows,
                                          int kv_len) const {
    return k0 + tile > kv_len || (mode != kFull && k0 + tile - 1 > r0) ||
           (mode == kLocal && k0 <= r0 + rows - 1 - window);
  }
};

// A row's log-sum-exp of its scaled scores from its running max m (scaled
// units) and sum l, with JAX's guard: a row whose sum is 0 takes l = 1.
__device__ __forceinline__ float row_lse(float m, float l) {
  return m + logf(l == 0.0f ? 1.0f : l);
}

constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ Mask row_mask(int mode, int window, const int* prefix_len, int b) {
  return Mask{mode, window, mode == kPrefix ? prefix_len[b] : 0};
}

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 32;  // key rows per tile (one per lane in the softmax)

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int H, int Hkv, int Tq, int Tk, int kv_len, float scale,
    int mode, int window, const int* __restrict__ prefix_len, float* __restrict__ lse) {
  constexpr int kRows = kThreads / D;     // output rows one pass covers
  constexpr int kOut = kBQ / kRows;       // accumulators per thread
  constexpr int kKS = D + 1;              // padded K row: conflict-free dots
  extern __shared__ float smem[];
  float* q_s = smem;                      // (kBQ, D)
  float* k_s = q_s + kBQ * D;             // (kBK, D + 1)
  float* v_s = k_s + kBK * kKS;           // (kBK, D)
  float* s_s = v_s + kBK * D;             // (kBQ, kBK)
  float* m_s = s_s + kBQ * kBK;           // (kBQ,)
  float* l_s = m_s + kBQ;
  float* corr_s = l_s + kBQ;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* qb = q + ((static_cast<long long>(b) * H + h) * Tq) * D;
  const T* kb = k + ((static_cast<long long>(b) * Hkv + hk) * Tk) * D;
  const T* vb = v + ((static_cast<long long>(b) * Hkv + hk) * Tk) * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D;
    q_s[i] = q0 + r < Tq ? rt::to_f32(qb[static_cast<long long>(q0) * D + i]) * scale : 0.0f;
  }
  for (int i = tid; i < kBQ; i += kThreads) {
    m_s[i] = rt::kNegInf;
    l_s[i] = 0.0f;
  }
  float acc[kOut];
#pragma unroll
  for (int r = 0; r < kOut; ++r) acc[r] = 0.0f;
  const int dd = tid % D, row0 = tid / D;

  const Mask mask = row_mask(mode, window, prefix_len, b);
  const int k_end = mask.k_end(q0, kBQ, kv_len);
  for (int k0 = mask.k_begin(q0, kBK); k0 < k_end; k0 += kBK) {
    __syncthreads();  // previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int j = i / D, c = i % D;
      const bool live = k0 + j < kv_len;
      const long long off = static_cast<long long>(k0) * D + i;
      k_s[j * kKS + c] = live ? rt::to_f32(kb[off]) : 0.0f;
      v_s[i] = live ? rt::to_f32(vb[off]) : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK, j = i % kBK;
      const int qi = q0 + r, kj = k0 + j;
      const int2 seen = mask.keys(qi, kv_len);
      const bool valid = kj >= seen.x && kj <= seen.y;
      float dot = 0.0f;
      if (valid) {
        const float* qr = q_s + r * D;
        const float* kr = k_s + j * kKS;
#pragma unroll 16
        for (int c = 0; c < D; ++c) dot += qr[c] * kr[c];
      }
      s_s[i] = valid ? dot : rt::kNegInf;
    }
    __syncthreads();
    for (int r = warp; r < kBQ; r += kThreads / 32) {
      const float sv = s_s[r * kBK + lane];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, rt::warp_max(sv));
      const float p = sv > rt::kNegInf ? expf(sv - m_new) : 0.0f;
      s_s[r * kBK + lane] = p;
      const float sum = rt::warp_sum(p);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kOut; ++r) {
      const int row = row0 + r * kRows;
      const float* pr = s_s + row * kBK;
      float a = acc[r] * corr_s[row];
#pragma unroll 8
      for (int j = 0; j < kBK; ++j) a += pr[j] * v_s[j * D + dd];
      acc[r] = a;
    }
  }
  __syncthreads();
  T* ob = out + ((static_cast<long long>(b) * H + h) * Tq) * D;
#pragma unroll
  for (int r = 0; r < kOut; ++r) {
    const int row = row0 + r * kRows;
    if (q0 + row < Tq) {
      const float l = l_s[row];
      const float o = acc[r] / (l == 0.0f ? 1.0f : l);
      ob[static_cast<long long>(q0 + row) * D + dd] = rt::from_f32<T>(o);
    }
  }
  if (lse != nullptr) {
    float* lb = lse + (static_cast<long long>(b) * H + h) * Tq;
    for (int r = tid; r < kBQ && q0 + r < Tq; r += kThreads) lb[q0 + r] = row_lse(m_s[r], l_s[r]);
  }
}

constexpr size_t smem_bytes(int D) {
  return sizeof(float) * static_cast<size_t>(kBQ * D + kBK * (D + 1) + kBK * D + kBQ * kBK +
                                             3 * kBQ);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int Hkv,
           int Tq, int Tk, float scale, int mode, int window, const int* prefix_len,
           float* lse, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(D);
  cudaError_t err = rt::allow_smem(flash_prefill_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, Hkv, Tq, Tk, Tk, scale, mode, window, prefix_len, lse);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 tensor-core body
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows
constexpr int kTile = 64;         // query rows per block, keys per K/V tile

// Grid (H, B, ceil(Tq / 64)); blockIdx.z = 0 is the LAST q tile. Fragment
// layouts are those of mma.m16n8k16: lane = 4 * gid + tq; an accumulator
// tile's c[0..1] hold row gid, columns 2tq and 2tq+1, c[2..3] row gid+8.
// The minimum of 2 blocks per SM (up to D = 128; at D = 256 the shared
// memory admits one) and ex2.approx are timed against the default bounds
// and exp2f by `chip_smoke.py --variants`.
template <int D>
__global__ void __launch_bounds__(kMmaThreads, D <= 128 ? 2 : 1) flash_prefill_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int H, int Hkv,
    int Tq, int Tk, int kv_len, float scale_log2, int mode, int window,
    const int* __restrict__ prefix_len, float* __restrict__ lse) {
  constexpr bool kQReg = D <= 128;   // Q fragments kept in registers
  constexpr int kS = D + 8;          // padded smem row (elements): +16 B per row
  constexpr int kRowChunks = D / 8;  // 16-byte chunks per row
  constexpr int kND = D / 8;         // n tiles of the output (8 columns each)
  constexpr int kKD = D / 16;        // k steps of Q K^T
  constexpr int kNK = kTile / 8;     // n tiles of S (8 keys each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  auto* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (64, kS)
  __nv_bfloat16* k_s = q_s + kTile * kS;                     // 2 x (64, kS)
  __nv_bfloat16* v_s = k_s + 2 * kTile * kS;                 // 2 x (64, kS)

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTile;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tq = lane & 3;
  const __nv_bfloat16* qb = q + ((static_cast<long long>(b) * H + h) * Tq) * D;
  const __nv_bfloat16* kb = k + ((static_cast<long long>(b) * Hkv + hk) * Tk) * D;
  const __nv_bfloat16* vb = v + ((static_cast<long long>(b) * Hkv + hk) * Tk) * D;

  // Q tile (rows past Tq zero-filled) and K/V tile 0, one copy group
  for (int c = tid; c < kTile * kRowChunks; c += kMmaThreads) {
    const int r = c / kRowChunks, col = (c % kRowChunks) * 8;
    const bool ok = q0 + r < Tq;
    cp_async16(q_s + r * kS + col, ok ? qb + static_cast<long long>(q0 + r) * D + col : qb, ok);
  }
  auto load_kv = [&](int buf, int k0) {
    __nv_bfloat16* kd = k_s + buf * kTile * kS;
    __nv_bfloat16* vd = v_s + buf * kTile * kS;
    for (int c = tid; c < kTile * kRowChunks; c += kMmaThreads) {
      const int r = c / kRowChunks, col = (c % kRowChunks) * 8;
      const bool ok = k0 + r < kv_len;
      const long long off = ok ? static_cast<long long>(k0 + r) * D + col : 0;
      cp_async16(kd + r * kS + col, kb + off, ok);
      cp_async16(vd + r * kS + col, vb + off, ok);
    }
  };
  const Mask mask = row_mask(mode, window, prefix_len, b);
  const int k_first = mask.k_begin(q0, kTile);
  const int k_end = mask.k_end(q0, kTile, kv_len);
  const int nk = k_end > k_first ? (k_end - k_first + kTile - 1) / kTile : 0;
  load_kv(0, k_first);
  cp_async_commit();

  unsigned qf[kQReg ? kKD : 1][4];
  float o[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_r[2] = {-INFINITY, -INFINITY};  // raw-score row max, rows gid and gid+8
  float l_r[2] = {0.0f, 0.0f};            // this thread's share of the row sums
  const int row0 = q0 + warp * 16;        // the warp's first query row
  // the keys rows gid and gid + 8 see
  const int2 seen[2] = {mask.keys(row0 + gid, kv_len), mask.keys(row0 + gid + 8, kv_len)};

  if (nk == 0) cp_async_wait<0>();
  for (int j = 0; j < nk; ++j) {
    const int k0 = k_first + j * kTile;
    if (j + 1 < nk) {
      load_kv((j + 1) & 1, k0 + kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kQReg && j == 0) {
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk)
        ldmatrix_x4(qf[kQReg ? kk : 0],
                    q_s + (warp * 16 + (lane & 15)) * kS + kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* kt = k_s + (j & 1) * kTile * kS;
    const __nv_bfloat16* vt = v_s + (j & 1) * kTile * kS;

    // S = Q K^T: per k step, two key n tiles per ldmatrix.x4
    float s[kNK][4];
#pragma unroll
    for (int n = 0; n < kNK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
      const unsigned(&qa)[4] = qf[kQReg ? kk : 0];
      if (!kQReg)  // D = 256: this k step's Q fragment from shared memory
        ldmatrix_x4(qf[0], q_s + (warp * 16 + (lane & 15)) * kS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int n2 = 0; n2 < kNK / 2; ++n2) {
        unsigned bk[4];
        ldmatrix_x4(bk, kt + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * kS + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * n2], qa, bk[0], bk[1]);
        mma_bf16(s[2 * n2 + 1], qa, bk[2], bk[3]);
      }
    }
    // masks: keys at or past kv_len, and the keys the mode hides (above
    // the diagonal, past the prefix, below the window)
    if (mask.partial(k0, kTile, row0, 16, kv_len)) {
#pragma unroll
      for (int n = 0; n < kNK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + n * 8 + 2 * tq + (e & 1);
          const int2 r = seen[e >> 1];
          if (kj < r.x || kj > r.y) s[n][e] = -INFINITY;
        }
    }
    // online softmax in registers; m stays in raw-score units
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_r[r];
#pragma unroll
      for (int n = 0; n < kNK; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = quad_max(mx);
      const float base = mx == -INFINITY ? 0.0f : mx * scale_log2;
      const float corr = ex2(m_r[r] * scale_log2 - base);
      m_r[r] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < kNK; ++n) {
        s[n][2 * r] = ex2(fmaf(s[n][2 * r], scale_log2, -base));
        s[n][2 * r + 1] = ex2(fmaf(s[n][2 * r + 1], scale_log2, -base));
        sum += s[n][2 * r] + s[n][2 * r + 1];
      }
      l_r[r] = l_r[r] * corr + sum;
#pragma unroll
      for (int n = 0; n < kND; ++n) {
        o[n][2 * r] *= corr;
        o[n][2 * r + 1] *= corr;
      }
    }
    // O += P V: P (bf16, registers) as the A operand, 16 keys per k step
#pragma unroll
    for (int kk = 0; kk < kNK / 2; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < kND / 2; ++n2) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kS +
                                  n2 * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * n2], pa, bv[0], bv[1]);
        mma_bf16(o[2 * n2 + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it refills
  }

  __nv_bfloat16* ob = out + ((static_cast<long long>(b) * H + h) * Tq) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_r[r]);
    const float inv = 1.0f / (l == 0.0f ? 1.0f : l);
    const int qi = row0 + gid + r * 8;
    if (qi < Tq) {
      auto* orow = reinterpret_cast<unsigned*>(ob + static_cast<long long>(qi) * D);
#pragma unroll
      for (int n = 0; n < kND; ++n)
        orow[n * 4 + tq] = pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
      // m_r is in raw-score units: m_r * scale = m_r * scale_log2 * ln 2
      if (lse != nullptr && tq == 0)
        lse[(static_cast<long long>(b) * H + h) * Tq + qi] =
            row_lse(m_r[r] == -INFINITY ? rt::kNegInf : m_r[r] * scale_log2 * kLn2, l);
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B, int H, int Hkv,
               int Tq, int Tk, float scale, int mode, int window, const int* prefix_len,
               float* lse, cudaStream_t stream) {
  constexpr size_t smem = sizeof(__nv_bfloat16) * 5 * kTile * (D + 8);
  cudaError_t err = rt::allow_smem(flash_prefill_mma_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, B, (Tq + kTile - 1) / kTile);
  constexpr float kLog2e = 1.4426950408889634f;
  flash_prefill_mma_kernel<D><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), H, Hkv, Tq, Tk,
      Tk, scale * kLog2e, mode, window, prefix_len, lse);
  return static_cast<int>(cudaGetLastError());
}

#define FP_MASK_ARGS scale, mode, window, prefix_len, lse, stream

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, int H, int Hkv,
             int Tq, int Tk, int d, float scale, int mode, int window, const int* prefix_len,
             float* lse, cudaStream_t stream) {
  if (d == 32) return launch<T, 32>(q, k, v, out, B, H, Hkv, Tq, Tk, FP_MASK_ARGS);
  if (d == 64) return launch<T, 64>(q, k, v, out, B, H, Hkv, Tq, Tk, FP_MASK_ARGS);
  if (d == 128) return launch<T, 128>(q, k, v, out, B, H, Hkv, Tq, Tk, FP_MASK_ARGS);
  if (d == 256) return launch<T, 256>(q, k, v, out, B, H, Hkv, Tq, Tk, FP_MASK_ARGS);
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_mma_d(const void* q, const void* k, const void* v, void* out, int B, int H, int Hkv,
                 int Tq, int Tk, int d, float scale, int mode, int window, const int* prefix_len,
                 float* lse, cudaStream_t stream) {
  if (d == 32) return launch_mma<32>(q, k, v, out, B, H, Hkv, Tq, Tk, FP_MASK_ARGS);
  if (d == 64) return launch_mma<64>(q, k, v, out, B, H, Hkv, Tq, Tk, FP_MASK_ARGS);
  if (d == 128) return launch_mma<128>(q, k, v, out, B, H, Hkv, Tq, Tk, FP_MASK_ARGS);
  if (d == 256) return launch_mma<256>(q, k, v, out, B, H, Hkv, Tq, Tk, FP_MASK_ARGS);
  return static_cast<int>(cudaErrorInvalidValue);
}

#undef FP_MASK_ARGS

}  // namespace

// q (B, H, Tq, d), k/v (B, Hkv, Tk, d), out (B, H, Tq, d), all contiguous,
// bf16 (is_bf16 = 1) or fp32; d in {32, 64, 128, 256}. mode: 0 full, 1
// causal, 2 prefix (prefix_len: (B,) int32 on the device), 3 local
// (window > 0); prefix_len may be null in the other modes. lse: null, or
// (B, H, Tq) fp32 for each row's log-sum-exp of its scaled scores (the
// backward of the training path's flash attention). bf16 with
// 16-byte aligned pointers (and fewer than 65536 q tiles) runs on the
// tensor cores, everything else on the FMA body.
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v, void* out,
                                    int is_bf16, int B, int H, int Hkv, int Tq, int Tk, int d,
                                    float scale, int mode, int window, const void* prefix_len,
                                    void* lse, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Tq <= 0 || Tk <= 0 || H > 65535 ||
      B > 65535 || mode < kFull || mode > kLocal || (mode == kLocal && window <= 0) ||
      (mode == kPrefix && prefix_len == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* pl = static_cast<const int*>(prefix_len);
  auto* ls = static_cast<float*>(lse);
  if (is_bf16 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out) &&
      (Tq + kTile - 1) / kTile <= 65535)
    return launch_mma_d(q, k, v, out, B, H, Hkv, Tq, Tk, d, scale, mode, window, pl, ls, s);
  if (is_bf16)
    return launch_d<__nv_bfloat16>(q, k, v, out, B, H, Hkv, Tq, Tk, d, scale, mode, window, pl,
                                   ls, s);
  return launch_d<float>(q, k, v, out, B, H, Hkv, Tq, Tk, d, scale, mode, window, pl, ls, s);
}
