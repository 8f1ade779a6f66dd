// LUT q.K~ scores over the dense grouped cache, no softmax (replaces the
// Pallas kernel repro/kernels/polar_qk.py::polar_qk_scores — the paper's
// Appendix-A kernel).
//
// Bound: bytes — codes (g*P B) and stats (4*P*4 B) per group, the fp32
// score rows written (Qh*g*4 B per group) — against 2*Qh*g*P flops of
// gathered FMAs. At the serving shapes the arithmetic is small and the
// kernel is bound by latency: one launch, one DRAM round trip, the LUT
// build, the scoring pass and the stores, in series. The design shortens
// that chain:
//
//   * One block of 128 threads per (group n, kv head h, row b), which
//     restages q for each group; the query heads are split across
//     threads. Blocks that own several groups of one (row, kv head) and
//     stage q once are timed against it by `chip_smoke.py --variants`
//     (PERF.md §6).
//   * Each thread owns kTok = 2 consecutive tokens of one group and
//     kRows = 4 query heads. Its code rows (2 * P contiguous bytes) go
//     from global memory straight into registers with 16-byte loads,
//     issued FIRST; q and the stat rows are staged in shared memory and
//     the group's angle LUT A[qh][p][a] (rt::build_angle_lut: one precise
//     sincosf per pair and state, then one product pair per query head)
//     is built while the code loads are still in flight. No byte-wise
//     staging of the codes.
//   * Scoring dequantizes rho~ once per (token, pair) and adds
//     rho~ * A[qh][p][code] for each of its query heads. The vector path
//     is compiled per (P, t_bits), so every LUT offset but the code's is
//     an immediate; the 32 lanes of a warp read one group's 2^t-entry LUT
//     segment per head, free of bank conflicts.
//   * The two lanes of a pair hold 4 consecutive tokens; they trade two
//     heads with one shuffle each, and every lane writes two heads' four
//     scores as float4s.
//
// The vector path needs P in {16, 32, 64} (d in {32, 64, 128}), t_bits in
// {3, 4}, g % 4 == 0 and 16-byte aligned codes and output. Any other shape
// the wrapper takes runs a generic path of the same kernel: one token per
// thread, code bytes read from global memory, scalar stores.
//
// Every position of the (B, Hkv, Qh, G*g) output is written: a group not
// yet filled holds zero stats and scores to a finite 0, which the caller
// masks. The score spill to memory is what the fused decode kernel
// (polar_attention.cu) removes.
#include <cstdint>

#include "lut_decode.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;              // query heads per thread (the store trades two)
constexpr int kTok = 2;               // consecutive tokens per thread (vector path)
static_assert(kRows == 4 && kTok == 2, "the float4 store trades two heads of two tokens");

// byte i of a register array of code rows (i is a constant after unrolling)
template <int N>
__device__ __forceinline__ unsigned code_byte(const uint4 (&cr)[N], int i) {
  const uint4 v = cr[i >> 4];
  const int w = (i >> 2) & 3;
  const unsigned x = w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
  return (x >> ((i & 3) * 8)) & 0xffu;
}

// kP > 0: the vector path with P = kP and t_bits = kTB, every index a
// constant but the code; kP == 0: the generic path (runtime P, t_bits).
template <int kP, int kTB>
__global__ void __launch_bounds__(kThreads) polar_qk_kernel(
    const float* __restrict__ q, const unsigned char* __restrict__ codes,
    const float* __restrict__ rs, const float* __restrict__ rz, const float* __restrict__ ts,
    const float* __restrict__ tz, float* __restrict__ out, int Hkv, int Qh, int d, int G, int g,
    int t_bits_arg) {
  constexpr bool kVec = kP > 0;
  constexpr int kT = kVec ? kTok : 1;  // tokens per thread
  constexpr int kWords = kVec ? kTok * kP / 16 : 1;
  extern __shared__ float smem[];
  const int t_bits = kVec ? kTB : t_bits_arg;
  const int P = kVec ? kP : d / 2;
  const int NT = 1 << t_bits, PNT = P * NT;
  const int QhP = (Qh + kRows - 1) / kRows * kRows;  // LUT rows, padded to kRows
  const unsigned tmask = static_cast<unsigned>(NT - 1);
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long bh = static_cast<long long>(b) * Hkv + h;
  const long long grp = bh * G + n;
  const int tpg = g / kT;  // token slots of the group
  const int nitems = tpg * (QhP / kRows);
  float* q_s = smem;         // (Qh, d)
  float* st = q_s + Qh * d;  // (4, P): rho scale, rho zero, theta scale, theta zero
  float* lut = st + 4 * P;   // (QhP, P, NT); rows past Qh are never stored
  const int tid = threadIdx.x;

  // item w -> (first token t0, first query head r0); consecutive lanes
  // take consecutive token slots of one head chunk
  auto t0_of = [&](int w) { return (w % tpg) * kT; };
  auto r0_of = [&](int w) { return (w / tpg) * kRows; };
  uint4 cr[kWords];
  auto load_codes = [&](int w) {
    if constexpr (kVec) {
      const auto* src = reinterpret_cast<const uint4*>(codes + (grp * g + t0_of(w)) * kP);
#pragma unroll
      for (int i = 0; i < kWords; ++i) cr[i] = __ldg(src + i);
    }
  };
  // 1. the first item's codes, in flight during stages 2 and 3
  if (tid < nitems) load_codes(tid);
  // 2. q and the group's stat rows
  for (int i = tid; i < Qh * d; i += kThreads) q_s[i] = q[bh * Qh * d + i];
  rt::load_group_stats(st, rs, rz, ts, tz, grp * P, P);
  __syncthreads();
  // 3. the LUT lut[qh][p][a] (2 * P is a constant on the vector path)
  rt::build_angle_lut(q_s, st, lut, Qh, 2 * P, t_bits);

  // 4. scores: per (token, pair) one rho~ and one gathered entry per head;
  // on the vector path the heads' and pairs' LUT offsets are immediates
  const long long T = static_cast<long long>(G) * g;
  for (int w = tid; w < nitems; w += kThreads) {
    if (w != tid) load_codes(w);
    const int t0 = t0_of(w), r0 = r0_of(w);
    const float* lq = lut + r0 * PNT;  // LUT row r0
    float acc[kT][kRows];
#pragma unroll
    for (int k = 0; k < kT; ++k)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[k][r] = 0.0f;
    auto add = [&](float (&a)[kRows], unsigned c, int p, float sr, float sz) {
      const float rho = (static_cast<float>(c >> t_bits) + 0.5f) * sr + sz;
      const float* le = lq + p * NT + (c & tmask);
#pragma unroll
      for (int r = 0; r < kRows; ++r) a[r] += rho * le[r * PNT];
    };
    if constexpr (kVec) {
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const float sr = st[p], sz = st[P + p];
#pragma unroll
        for (int k = 0; k < kTok; ++k) add(acc[k], code_byte(cr, k * kP + p), p, sr, sz);
      }
    } else {
      const unsigned char* crow = codes + (grp * g + t0) * P;
      for (int p = 0; p < P; ++p) add(acc[0], crow[p], p, st[p], st[P + p]);
    }
    float* ob = out + bh * Qh * T + static_cast<long long>(n) * g;
    if constexpr (kVec) {
      // a lane pair holds tokens t..t+3 of heads r0..r0+3: the even lane
      // trades its heads r0+2, r0+3 for the odd lane's heads r0, r0+1, and
      // each writes its two heads' four tokens as float4s
      const bool odd = tid & 1;
      const unsigned pair = 3u << (tid & 30);
      float x[kTok][2];
#pragma unroll
      for (int k = 0; k < kTok; ++k)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          x[k][i] = __shfl_xor_sync(pair, odd ? acc[k][i] : acc[k][i + 2], 1);
      const int t = odd ? t0 - kTok : t0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = odd ? r0 + 2 + i : r0 + i;
        const float4 v = odd ? make_float4(x[0][i], x[1][i], acc[0][i + 2], acc[1][i + 2])
                             : make_float4(acc[0][i], acc[1][i], x[0][i], x[1][i]);
        if (r < Qh) *reinterpret_cast<float4*>(ob + r * T + t) = v;
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r0 + r < Qh) ob[(r0 + r) * T + t0] = acc[0][r];
    }
  }
}

template <int kP, int kTB>
int launch(const void* q, const void* codes, const void* rs, const void* rz, const void* ts,
           const void* tz, void* out, int B, int Hkv, int Qh, int d, int G, int g, int t_bits,
           cudaStream_t stream) {
  const size_t P = d / 2, QhP = (Qh + kRows - 1) / kRows * kRows;
  const size_t smem = sizeof(float) * (static_cast<size_t>(Qh) * d + 4 * P + (QhP * P << t_bits));
  cudaError_t err = rt::allow_smem(polar_qk_kernel<kP, kTB>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const dim3 grid(G, Hkv, B);
  polar_qk_kernel<kP, kTB><<<grid, kThreads, smem, stream>>>(
      f(q), static_cast<const unsigned char*>(codes), f(rs), f(rz), f(ts), f(tz),
      static_cast<float*>(out), Hkv, Qh, d, G, g, t_bits);
  return static_cast<int>(cudaGetLastError());
}

template <int kP>
int launch_t(const void* q, const void* codes, const void* rs, const void* rz, const void* ts,
             const void* tz, void* out, int B, int Hkv, int Qh, int d, int G, int g, int t_bits,
             cudaStream_t s) {
  if (t_bits == 4) return launch<kP, 4>(q, codes, rs, rz, ts, tz, out, B, Hkv, Qh, d, G, g, 4, s);
  if (t_bits == 3) return launch<kP, 3>(q, codes, rs, rz, ts, tz, out, B, Hkv, Qh, d, G, g, 3, s);
  return launch<0, 0>(q, codes, rs, rz, ts, tz, out, B, Hkv, Qh, d, G, g, t_bits, s);
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
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = g % (2 * kTok) == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec && d == 32) return launch_t<16>(q, codes, rs, rz, ts, tz, out, B, Hkv, Qh, d, G, g, t_bits, s);
  if (vec && d == 64) return launch_t<32>(q, codes, rs, rz, ts, tz, out, B, Hkv, Qh, d, G, g, t_bits, s);
  if (vec && d == 128) return launch_t<64>(q, codes, rs, rz, ts, tz, out, B, Hkv, Qh, d, G, g, t_bits, s);
  return launch<0, 0>(q, codes, rs, rz, ts, tz, out, B, Hkv, Qh, d, G, g, t_bits, s);
}
