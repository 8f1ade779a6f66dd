// Page-native fused PolarQuant decode attention over the flushed groups
// (replaces the Pallas kernel repro/kernels/paged_decode.py::
// polar_paged_decode_grouped and its LUT tile
// repro/kernels/polar_attention.py::_lut_scores_block).
//
// Group n of slot s is pool page table[s, n]; a slot walks its LIVE pages
// only (ceil(flushed[s] / g)), skipping entries outside the pool. The body
// is lut_decode.cuh's split, double-buffered one: each (slot, kv head)'s
// page walk is split into nsplit ranges, one block each, chosen by the
// host from S, Hkv and the table width N (kernels/paged_decode.py::
// plan_splits; it never reads `flushed`, so no device sync), and the
// splits' partials are merged on the device inside this call. Shapes it
// does not take (d % 32 != 0, unaligned buffers) run the unsplit body.
//
// Value rows are bf16, fp32 or uint8 mid-tread codes with one fp32 scale
// and zero per row (the TPU kernel's uint8 branch, repro/kernels/
// paged_decode.py:81); the split body folds the scale into p (see
// lut_decode.cuh).
//
// Bound: bytes — each live page's codes (g*P B), stats (4*P*4 B) and
// value rows (g*d*2 B in bf16; g*d + 8*g B as uint8 codes with their
// scales and zeros) are read once per (slot, kv head). The time
// follows the per-page dependent chain (DRAM round trip, angle LUT,
// scores, softmax, p @ V): splitting runs the chains of one slot side by
// side (8 slots x 4 kv heads x 8 pages: 256 blocks on 132 SMs), and
// double-buffering overlaps the next page's loads with the current page
// inside a split.
#include "lut_decode.cuh"

namespace {

// group n of slot s -> (page, h) pool index, or -1 for an unassigned entry
struct PagedGroups {
  const int* table;
  long long stride;
  int count;  // table width N
  int PP, Hkv;
  __device__ __forceinline__ long long index(int s, int h, int n) const {
    const int page = table[s * stride + n];
    if (page < 0 || page >= PP) return -1;
    return static_cast<long long>(page) * Hkv + h;
  }
};

}  // namespace

// q (S, Hkv, Qh, d) fp32 pre-scaled; pools codes (PP, Hkv, g, d/2) uint8,
// stats (PP, Hkv, 1, d/2) fp32, values (PP, Hkv, g, d) of v_kind
// (rt::ValueKind: fp32, bf16, or uint8 with vscale / vzero (PP, Hkv, g, 1)
// fp32; null otherwise);
// table (S, >=N) int32 with row stride table_stride; flushed (S,) int32.
// Outputs acc (S, Hkv, Qh, d), m and l (S, Hkv, Qh), all fp32. nsplit: the
// host's split count; partials: nsplit * S * Hkv * Qh * (d + 2) fp32 of
// scratch when nsplit > 1 (else unused, may be null). *split_body is set to
// 1 when the split body ran, 0 when the unsplit one did.
extern "C" int paged_decode_launch(const void* q, const void* codes, const void* rs,
                                   const void* rz, const void* ts, const void* tz,
                                   const void* values, int v_kind, const void* vscale,
                                   const void* vzero, const void* table,
                                   long long table_stride, int N, const void* flushed,
                                   void* acc, void* m, void* l, int S, int Hkv, int Qh, int d,
                                   int g, int PP, int t_bits, int nsplit, void* partials,
                                   int* split_body, void* stream) {
  if (S <= 0 || Hkv <= 0 || Qh <= 0 || d <= 0 || d % 2 || g <= 0 || S > 65535 || t_bits > 8 ||
      split_body == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const unsigned char*>(codes);
  const PagedGroups groups{static_cast<const int*>(table), table_stride, N, PP, Hkv};
  const auto* fl = static_cast<const int*>(flushed);
  auto* a = static_cast<float*>(acc);
  auto* mm = static_cast<float*>(m);
  auto* ll = static_cast<float*>(l);
  const bool split = rt::lut_split_decode_fits(d, codes, rs, rz, ts, tz, values);
  *split_body = split;
  return rt::with_value_type(v_kind, [&](auto tv) {
    using TV = decltype(tv);
    if (split)
      return rt::launch_lut_split_decode<TV>(f(q), c, f(rs), f(rz), f(ts), f(tz), values,
                                             f(vscale), f(vzero), groups, fl, a, mm, ll,
                                             static_cast<float*>(partials), S, Hkv, Qh, d, g,
                                             t_bits, N, nsplit, st);
    return rt::launch_lut_flash_decode<TV>(f(q), c, f(rs), f(rz), f(ts), f(tz), values,
                                           f(vscale), f(vzero), groups, fl, a, mm, ll, S, Hkv,
                                           Qh, d, g, t_bits, st);
  });
}
