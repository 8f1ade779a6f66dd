// Fused PolarQuant decode attention over the grouped segment of the DENSE
// cache (replaces the Pallas kernel repro/kernels/polar_attention.py::
// polar_decode_attention_grouped).
//
// The LUT flash-decode bodies live in lut_decode.cuh (shared with the
// page-walking kernel, paged_decode.cu); here group n of row b is
// (b, h, n) of the dense (B, Hkv, G, g, P) code buffer, its (B, Hkv, G, 1, P)
// stat rows and the token-major (B, Hkv, G*g, d) value rows, so group
// index * g * d is a group's value offset and group index * g its uint8
// scales' and zeros'. Each row walks its LIVE groups only
// (ceil(length[b] / g)), where the TPU kernel walks all G and masks; value
// rows past length[b] are staged as zeros, so NaN there never enters a sum.
//
// The walk runs on the split, double-buffered body: each (row, kv head)'s
// G groups are cut into nsplit ranges, one block each, with nsplit chosen
// by the host from B, Hkv and G (kernels/paged_decode.py::plan_splits; it
// never reads `length`, so no device sync), and the splits' partials are
// merged on the device inside this call. A split whose range holds no live
// group writes m = kNegInf, l = 0, which the merge weighs by e^(m - max) =
// 0 (or, for a row of length 0, leaves at m = kNegInf, l = 0, acc = 0).
// Shapes the split body does not take (d % 32 != 0, unaligned buffers,
// uint8 rows with g % 4 != 0) run the unsplit body, one block per
// (kv head, row).
//
// Value rows are bf16, fp32 or uint8 mid-tread codes with one fp32 scale
// and zero per row (the TPU kernel's uint8 branch, repro/kernels/
// polar_attention.py:84); the split body folds the scale into p (see
// lut_decode.cuh).
//
// Bound: bytes — each live group's codes (g*P B), stats (4*P*4 B) and
// value rows (g*d*2 B in bf16; g*d + 8*g B as uint8 codes with their
// scales and zeros) are read once per (row, kv head). The time follows
// the per-group dependent chain (DRAM round trip, angle LUT, scores,
// softmax, p @ V): at 8 rows x 4 kv heads x 9 groups the split runs 160
// chains side by side where one block per (kv head, row) ran 32.
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
// otherwise); length (B,) int32 valid grouped tokens per row. Outputs acc
// (B, Hkv, Qh, d), m and l (B, Hkv, Qh), all fp32. nsplit: the host's split
// count; partials: nsplit * B * Hkv * Qh * (d + 2) fp32 of scratch when
// nsplit > 1 (else unused, may be null). *split_body is set to 1 when the
// split body ran, 0 when the unsplit one did.
extern "C" int polar_attention_launch(const void* q, const void* codes, const void* rs,
                                      const void* rz, const void* ts, const void* tz,
                                      const void* values, int v_kind, const void* vscale,
                                      const void* vzero, const void* length,
                                      void* acc, void* m, void* l, int B, int Hkv, int Qh,
                                      int d, int G, int g, int t_bits, int nsplit,
                                      void* partials, int* split_body, void* stream) {
  if (B <= 0 || Hkv <= 0 || Qh <= 0 || d <= 0 || d % 2 || G <= 0 || g <= 0 || B > 65535 ||
      t_bits > 8 || split_body == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const unsigned char*>(codes);
  const DenseGroups groups{G, Hkv};
  const auto* len = static_cast<const int*>(length);
  auto* a = static_cast<float*>(acc);
  auto* mm = static_cast<float*>(m);
  auto* ll = static_cast<float*>(l);
  const bool split = rt::lut_split_decode_fits(d, codes, rs, rz, ts, tz, values) &&
                     (v_kind != rt::kValueU8 || g % 4 == 0);
  *split_body = split;
  return rt::with_value_type(v_kind, [&](auto tv) {
    using TV = decltype(tv);
    if (split)
      return rt::launch_lut_split_decode<TV>(f(q), c, f(rs), f(rz), f(ts), f(tz), values,
                                             f(vscale), f(vzero), groups, len, a, mm, ll,
                                             static_cast<float*>(partials), B, Hkv, Qh, d, g,
                                             t_bits, G, nsplit, st);
    return rt::launch_lut_flash_decode<TV>(f(q), c, f(rs), f(rz), f(ts), f(tz), values,
                                           f(vscale), f(vzero), groups, len, a, mm, ll, B, Hkv,
                                           Qh, d, g, t_bits, st);
  });
}
