// Causal GQA flash attention forward for whole-prompt prefill (replaces
// the Pallas kernel repro/kernels/flash_prefill.py::flash_prefill; the
// JAX serving path computes the same function with the jnp
// core/attention.flash_attention).
//
// One block per (q tile of kBQ rows, head h, batch b); kv head h / (H/Hkv).
// The block keeps its scaled Q tile, one K/V tile of kBK rows, the score
// tile and the online-softmax carry in shared memory and its share of
// the fp32 output accumulator in registers. The k loop stops at the
// causal bound (tiles wholly above the diagonal are never visited), keys
// past kv_len are masked, and rows whose every key is masked finish with
// l == 0 and are written as zeros (the l == 0 guard).
//
// Bound: operations — ~4*Tq*Tk/2*d FLOPs per head against O(T*d) bytes.
// This first version runs them as plain fp32 FMAs from shared memory, far
// below the tensor cores' rate: mma/wgmma tiles are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;  // query rows per block
constexpr int kBK = 32;  // key rows per tile (one per lane in the softmax)

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int H, int Hkv, int Tq, int Tk, int kv_len, float scale,
    int causal) {
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

  const int k_end = causal ? min(kv_len, q0 + kBQ) : kv_len;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
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
      const bool valid = kj < kv_len && (!causal || qi >= kj);
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
}

constexpr size_t smem_bytes(int D) {
  return sizeof(float) * static_cast<size_t>(kBQ * D + kBK * (D + 1) + kBK * D + kBQ * kBK +
                                             3 * kBQ);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int Hkv,
           int Tq, int Tk, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(D);
  cudaError_t err = rt::allow_smem(flash_prefill_kernel<T, D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tq + kBQ - 1) / kBQ, H, B);
  flash_prefill_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, Hkv, Tq, Tk, Tk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B, int H, int Hkv,
             int Tq, int Tk, int d, float scale, int causal, cudaStream_t stream) {
  if (d == 32) return launch<T, 32>(q, k, v, out, B, H, Hkv, Tq, Tk, scale, causal, stream);
  if (d == 64) return launch<T, 64>(q, k, v, out, B, H, Hkv, Tq, Tk, scale, causal, stream);
  if (d == 128) return launch<T, 128>(q, k, v, out, B, H, Hkv, Tq, Tk, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B, H, Tq, d), k/v (B, Hkv, Tk, d), out (B, H, Tq, d), all contiguous,
// bf16 (is_bf16 = 1) or fp32; d in {32, 64, 128}.
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v, void* out,
                                    int is_bf16, int B, int H, int Hkv, int Tq, int Tk, int d,
                                    float scale, int causal, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Tq <= 0 || Tk <= 0 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_d<__nv_bfloat16>(q, k, v, out, B, H, Hkv, Tq, Tk, d, scale, causal, s);
  return launch_d<float>(q, k, v, out, B, H, Hkv, Tq, Tk, d, scale, causal, s);
}
