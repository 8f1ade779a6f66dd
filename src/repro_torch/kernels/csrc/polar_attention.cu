// Fused PolarQuant decode attention over the grouped segment of the DENSE
// cache (replaces the Pallas kernel repro/kernels/polar_attention.py::
// polar_decode_attention_grouped).
//
// The LUT flash-decode body lives in lut_decode.cuh (shared with the
// page-walking kernel, paged_decode.cu); here group n of row b is
// (b, h, n) of the dense (B, Hkv, G, g, P) code buffer, its (B, Hkv, G, 1, P)
// stat rows and the token-major (B, Hkv, G*g, d) value rows. One block per
// (kv head, row) walks the row's LIVE groups only (ceil(length[b] / g)),
// where the TPU kernel walks all G and masks; value rows past length[b]
// are staged as zeros, so NaN there never enters the sum. The codes and
// value rows are read with 16-byte loads, so the pointers must be
// 16-byte aligned (the launch returns cudaErrorMisalignedAddress).
//
// Value rows are bf16, fp32 or uint8 mid-tread codes with one fp32 scale
// and zero per row (the TPU kernel's uint8 branch, repro/kernels/
// polar_attention.py:84), dequantized while they are staged.
//
// Bound: bytes — each live group's codes (g*P B), stats (4*P*4 B) and
// value rows (g*d*2 B in bf16; g*d + 8*g B as uint8 codes with their
// scales and zeros) are read once per (row, kv head). The grid
// is only B*Hkv blocks (32 at 8 rows x 4 kv heads), far below the 132
// SMs: splitting groups across blocks is the first thing to fix.
#include "lut_decode.cuh"

namespace {

// group n of row s -> index into the dense (B, Hkv, G) group axis
struct DenseGroups {
  int count;  // G
  int Hkv;
  __device__ __forceinline__ long long index(int s, int h, int n) const {
    return (static_cast<long long>(s) * Hkv + h) * count + n;
  }
};

}  // namespace

// q (B, Hkv, Qh, d) fp32 pre-scaled; codes (B, Hkv, G, g, d/2) uint8; stats
// (B, Hkv, G, 1, d/2) fp32; values (B, Hkv, G*g, d) of v_kind (rt::ValueKind:
// fp32, bf16, or uint8 with vscale / vzero (B, Hkv, G*g, 1) fp32; null
// otherwise); length (B,) int32 valid grouped tokens per row. Outputs acc (B, Hkv, Qh, d), m and l
// (B, Hkv, Qh), all fp32.
extern "C" int polar_attention_launch(const void* q, const void* codes, const void* rs,
                                      const void* rz, const void* ts, const void* tz,
                                      const void* values, int v_kind, const void* vscale,
                                      const void* vzero, const void* length,
                                      void* acc, void* m, void* l, int B, int Hkv, int Qh,
                                      int d, int G, int g, int t_bits, void* stream) {
  if (B <= 0 || Hkv <= 0 || Qh <= 0 || d <= 0 || d % 2 || G <= 0 || g <= 0 || B > 65535 ||
      t_bits > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const unsigned char*>(codes);
  const DenseGroups groups{G, Hkv};
  const auto* len = static_cast<const int*>(length);
  auto* a = static_cast<float*>(acc);
  auto* mm = static_cast<float*>(m);
  auto* ll = static_cast<float*>(l);
  return rt::with_value_type(v_kind, [&](auto tv) {
    return rt::launch_lut_flash_decode<decltype(tv)>(f(q), c, f(rs), f(rz), f(ts), f(tz),
                                                     values, f(vscale), f(vzero), groups, len,
                                                     a, mm, ll, B, Hkv, Qh, d, g, t_bits, st);
  });
}
