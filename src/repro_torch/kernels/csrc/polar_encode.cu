// Polar group encode of post-RoPE keys (replaces the Pallas kernel
// repro/kernels/polar_encode.py::polar_encode).
//
// One block per (group n, kv head h, row b). The block's (g, d) key tile
// is read twice: pass 1 computes rho = sqrt(x^2 + y^2) and
// theta = atan2(y, x) + pi over the "half" pairs (x = k[:, p],
// y = k[:, p + P]) and reduces per-pair min/max over the g tokens
// (registers, then shared memory); pass 2 recomputes rho/theta (same
// arithmetic, same bits) and writes the mid-rise codes
// floor((v - min) / s), s = max((max - min) / 2^bits, 1e-8), packed as
// (rho_code << t) | theta_code, plus the four stat rows.
//
// With `pages` given, group (b, n) goes to pool page pages[b * G + n] —
// the JAX encode-then-scatter fused into one launch; a negative page id
// skips the group (decode steps re-encode every slot's residual but only
// flushing slots write).
//
// Bound: bytes. Per group it reads g*d key elements and writes g*P code
// bytes + 4*P stats; the arithmetic (one sqrt and one atan2 per pair) is
// small next to that. The second read of the tile hits L1/L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
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

template <typename T>
__global__ void __launch_bounds__(kThreads) polar_encode_kernel(
    const T* __restrict__ k, long long sb, long long sh, long long sn, long long st,
    int H, int G, int g, int P, const int* __restrict__ pages,
    unsigned char* __restrict__ codes, float* __restrict__ rs, float* __restrict__ rz,
    float* __restrict__ ts, float* __restrict__ tz, int r_bits, int t_bits) {
  const int n = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  long long o;  // output group index: (b, h, n) dense, or (page, h) paged
  if (pages != nullptr) {
    const int page = pages[static_cast<long long>(b) * G + n];
    if (page < 0) return;
    o = static_cast<long long>(page) * H + h;
  } else {
    o = (static_cast<long long>(b) * H + h) * G + n;
  }
  const T* kt = k + b * sb + h * sh + n * sn;

  const int tid = threadIdx.x;
  const int lanes = kThreads / P;  // token lanes per pair
  const int p = tid % P, lane = tid / P;
  const bool active = lane < lanes;

  float rmn = INFINITY, rmx = -INFINITY, tmn = INFINITY, tmx = -INFINITY;
  if (active) {
    for (int t = lane; t < g; t += lanes) {
      float rho, th;
      to_polar(rt::to_f32(kt[t * st + p]), rt::to_f32(kt[t * st + p + P]), rho, th);
      rmn = fminf(rmn, rho);
      rmx = fmaxf(rmx, rho);
      tmn = fminf(tmn, th);
      tmx = fmaxf(tmx, th);
    }
  }
  __shared__ float red[4][kThreads];
  red[0][tid] = rmn;
  red[1][tid] = rmx;
  red[2][tid] = tmn;
  red[3][tid] = tmx;
  __syncthreads();
  if (tid < P) {
    for (int l = 1; l < lanes; ++l) {
      const int j = l * P + tid;
      rmn = fminf(rmn, red[0][j]);
      rmx = fmaxf(rmx, red[1][j]);
      tmn = fminf(tmn, red[2][j]);
      tmx = fmaxf(tmx, red[3][j]);
    }
    red[0][tid] = rmn;
    red[1][tid] = rmx;
    red[2][tid] = tmn;
    red[3][tid] = tmx;
  }
  __syncthreads();
  if (!active) return;
  rmn = red[0][p];
  rmx = red[1][p];
  tmn = red[2][p];
  tmx = red[3][p];
  const float rsc = fmaxf(__fdiv_rn(__fsub_rn(rmx, rmn), static_cast<float>(1 << r_bits)), kEps);
  const float tsc = fmaxf(__fdiv_rn(__fsub_rn(tmx, tmn), static_cast<float>(1 << t_bits)), kEps);
  if (lane == 0) {
    rs[o * P + p] = rsc;
    rz[o * P + p] = rmn;
    ts[o * P + p] = tsc;
    tz[o * P + p] = tmn;
  }
  const float rtop = static_cast<float>((1 << r_bits) - 1);
  const float ttop = static_cast<float>((1 << t_bits) - 1);
  unsigned char* ct = codes + o * g * P;
  for (int t = lane; t < g; t += lanes) {
    float rho, th;
    to_polar(rt::to_f32(kt[t * st + p]), rt::to_f32(kt[t * st + p + P]), rho, th);
    const unsigned rc = code_of(rho, rmn, rsc, rtop);
    const unsigned tc = code_of(th, tmn, tsc, ttop);
    ct[t * P + p] = static_cast<unsigned char>((rc << t_bits) | tc);
  }
}

}  // namespace

// k: element strides (sb, sh, sn, st) for (row, head, group, token); the
// pair axis is contiguous. Returns cudaGetLastError() after the launch.
extern "C" int polar_encode_launch(const void* k, int k_bf16, long long sb, long long sh,
                                   long long sn, long long st, int B, int H, int G, int g,
                                   int d, const int* pages, void* codes, void* rs, void* rz,
                                   void* ts, void* tz, int r_bits, int t_bits, void* stream) {
  const int P = d / 2;
  if (P <= 0 || P > kThreads || g <= 0 || B <= 0 || H <= 0 || G <= 0 || H > 65535 ||
      B > 65535 || r_bits + t_bits > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(G, H, B);
  auto s = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<unsigned char*>(codes);
  auto* a = static_cast<float*>(rs);
  auto* z = static_cast<float*>(rz);
  auto* e = static_cast<float*>(ts);
  auto* w = static_cast<float*>(tz);
  if (k_bf16) {
    polar_encode_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(k), sb, sh, sn, st, H, G, g, P, pages, c, a, z, e,
        w, r_bits, t_bits);
  } else {
    polar_encode_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(k), sb, sh, sn, st, H, G, g, P, pages, c, a, z, e, w,
        r_bits, t_bits);
  }
  return static_cast<int>(cudaGetLastError());
}
