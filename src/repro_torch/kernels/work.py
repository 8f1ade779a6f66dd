"""The work each hand-written kernel does: the bytes it must move and the
operations it must do, and the least time an H100 takes for them.

One source for two readers. ``chip_smoke.py`` calls these formulas with
the counts of its own inputs (the live pages or groups its data holds,
the visible pairs of its masks) for every kernel row's ``bound_ms``. The
kernel wrappers call them with counts read from their inputs' shapes and
host arguments only, never from tensor values, and report the result to
the dry run's counter (``launch/op_cost.py``): so one call counts the
same on CPU, meta and CUDA tensors. A decode kernel's shape count is its
walk over the whole table or buffer width (the lengths are data), and
#3's ``prefix`` mode counts its causal pairs (``prefix_len`` is data).

Bytes: each input read once, each output written once. Operations are
split by the unit that does them (``{"bf16": n}`` on the tensor cores,
``{"fp32": n}`` on the fp32 pipes); ``dot`` is the part that is matrix
products (q.k and p.V), kept apart as the dry run's ``dot_flops``;
``transcendentals`` counts exponentials (one per score) and encode's
angle and radius (two per pair).
"""
from __future__ import annotations

import dataclasses

#: NVIDIA H100 SXM5 (80 GB HBM3, 700 W board limit), NVIDIA's data sheet:
#: HBM3 bandwidth in bytes/s
HBM_BYTES_PER_S = 3.35e12
#: dense bf16 tensor-core and fp32 (non-tensor) peaks, operations/s
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
#: NVLink 4 (18 links), bytes/s each way
NVLINK_BYTES_PER_S = 450e9


@dataclasses.dataclass(frozen=True)
class Work:
    """One launch's work: ``nbytes``, ``ops`` {kind: operations}, of which
    ``dot`` are matrix products, and ``transcendentals``."""
    nbytes: float
    ops: dict
    dot: float = 0.0
    transcendentals: float = 0.0

    @property
    def flops(self) -> float:
        return float(sum(self.ops.values()))


def bound(nbytes: float, flops: float | dict, kind: str = "fp32"
          ) -> tuple[float, str]:
    """Least time (ms) of moving ``nbytes`` once and doing ``flops`` at the
    ``kind`` peak — or ``flops`` = {kind: operations}, each kind on its own
    units, which may run side by side — and which of the two bounds it."""
    ops = flops if isinstance(flops, dict) else {kind: flops}
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = max(n / PEAK_FLOPS[k] * 1e3 for k, n in ops.items())
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def work_bound(w: Work) -> tuple[float, str]:
    return bound(w.nbytes, w.ops)


def value_row_bytes(rows: int, d: int, elt: int) -> int:
    """Bytes of ``rows`` value rows of width ``d``: fp rows of ``elt``
    bytes an element, or (``elt`` 1) uint8 codes with one fp32 scale and
    zero a row."""
    return rows * d * elt if elt > 1 else rows * (d + 8)


def encode(tokens: int, hkv: int, d: int, g: int, *, pages: int = 0,
           key_bytes: int = 2, fixed: bool = False) -> Work:
    """#1 on ``tokens`` tokens (all rows) of ``hkv`` heads: the page list
    (``pages`` int32 entries, the paged form), the keys, one code byte a
    pair and four fp32 stat rows a group; ~22 fp32 operations a pair (20
    on the fixed grid, which reduces no angle)."""
    p = d // 2
    nbytes = pages * 4 + tokens * hkv * (d * key_bytes + p) \
        + 4 * (tokens // g) * hkv * p * 4
    return Work(nbytes, {"fp32": (20 if fixed else 22) * tokens * hkv * p},
                transcendentals=2 * tokens * hkv * p)


def _lut(qh: int, p: int, g: int, t_bits: int) -> int:
    """Per (row, kv head, group) tile: the angle LUT 3*Qh*P*2^t, rho~
    2*g*P once for every row, one FMA per gathered LUT entry 2*Qh*g*P."""
    return 3 * qh * p * (1 << t_bits) + 2 * g * p + 2 * qh * g * p


def paged_decode(units: int, *, s: int, hkv: int, qh: int, d: int, g: int,
                 table: int, value_elt: int, t_bits: int = 4) -> Work:
    """#2 over ``units`` (slot, kv head, page) tiles: q fp32, per tile the
    codes, stats and value rows, the table (``table`` int32 entries) and
    ``flushed``, and the (acc, m, l) partials out; per tile the LUT
    scores, the softmax ~4*Qh*g (8 with uint8 values: p_t s_t and
    p_t z_t) and p.V 2*Qh*g*d."""
    p = d // 2
    nbytes = s * hkv * qh * d * 4 \
        + units * (g * p + 4 * p * 4 + value_row_bytes(g, d, value_elt)) \
        + table * 4 + s * 4 + s * hkv * qh * (d + 2) * 4
    soft = (8 if value_elt == 1 else 4) * qh * g
    pv = 2 * qh * g * d
    return Work(nbytes, {"fp32": units * (_lut(qh, p, g, t_bits) + soft
                                          + pv)},
                dot=units * pv, transcendentals=units * qh * g)


def dense_decode(groups: int, *, b: int, hkv: int, qh: int, d: int, g: int,
                 value_elt: int, t_bits: int = 4) -> Work:
    """#5 over ``groups`` (row, kv head, group) tiles of the dense buffers:
    as :func:`paged_decode` with ``length`` (B,) for the table, the
    softmax ~4*Qh*g and, with uint8 values, one FMA per staged code
    2*g*d."""
    p = d // 2
    nbytes = b * hkv * qh * d * 4 \
        + groups * (g * p + 4 * p * 4 + value_row_bytes(g, d, value_elt)) \
        + b * 4 + b * hkv * qh * (d + 2) * 4
    pv = 2 * qh * g * d
    per = _lut(qh, p, g, t_bits) + 4 * qh * g + pv
    if value_elt == 1:
        per += 2 * g * d
    return Work(nbytes, {"fp32": groups * per}, dot=groups * pv,
                transcendentals=groups * qh * g)


def qk_scores(groups: int, *, b: int, hkv: int, qh: int, d: int, g: int,
              t_bits: int = 4) -> Work:
    """#6 over ``groups`` (row, kv head, group) tiles: q fp32, codes and
    stats in, fp32 scores (B, Hkv, Qh, groups' tokens) out; the LUT
    scores only."""
    p = d // 2
    nbytes = b * hkv * qh * d * 4 + groups * (g * p + 4 * p * 4) \
        + groups * qh * g * 4
    return Work(nbytes, {"fp32": groups * _lut(qh, p, g, t_bits)})


def visible_pairs(mode: str, tq: int, tk: int, window: int = 0) -> int:
    """(query, key) pairs one row of #3's mask lets through, from shapes:
    ``full`` every pair, ``causal`` key j <= query i, ``local`` also
    i - j < window; ``prefix`` is counted as ``causal`` (its bidirectional
    block is ``prefix_len``, data)."""
    if mode == "full":
        return tq * tk
    if mode == "local":
        return sum(max(0, min(i + 1, tk) - max(0, i - window + 1))
                   for i in range(tq))
    # causal, prefix: min(i + 1, tk) keys for query i
    full = min(tq, tk)
    return full * (full + 1) // 2 + (tq - full) * tk


def flash_prefill(b: int, h: int, hkv: int, tq: int, tk: int, d: int,
                  pairs: float, *, elt: int = 2, lse: bool = False) -> Work:
    """#3: q and out (B, H, Tq, d), k and v (B, Hkv, Tk, d) of ``elt``
    bytes, the fp32 ``lse`` (B, H, Tq) when asked; q.k and p.V over
    ``pairs`` visible (row, query, key) triples summed over the batch,
    4*H*d each, on the tensor cores for bf16."""
    nbytes = b * (2 * h * tq + 2 * hkv * tk) * d * elt \
        + (b * h * tq * 4 if lse else 0)
    ops = 4.0 * h * d * pairs
    return Work(nbytes, {"bf16" if elt == 2 else "fp32": ops}, dot=ops,
                transcendentals=h * pairs)


def paged_prefill(*, hkv: int, qh: int, d: int, g: int, start: int,
                  chunk: int, value_elt: int, kv_elt: int = 2,
                  t_bits: int = 4) -> Work:
    """#4, one chunk of ``chunk`` tokens at ``start`` (``start / g`` live
    prefix pages): per (kv head, page) the codes, stats and value rows,
    the page row, q fp32 (Hkv, Qh*chunk, d) in, the chunk's K/V and the
    fp32 output; the q.k and p.V products over the prefix and the causal
    chunk on the tensor cores (bf16 chunk) or fp32 pipes, the
    dequantization per (kv head, page) (4 an angle state, 4 a (token,
    pair)) and the softmax (~4 a (row, key)) at fp32; uint8 values add the
    codes widened once (g*d a page) and p_t s_t, p_t z_t (4 a prefix
    (row, key))."""
    p = d // 2
    n = start // g
    qt = qh * chunk
    nbytes = hkv * n * (g * p + 4 * p * 4 + value_row_bytes(g, d, value_elt)) \
        + n * 4 + hkv * qt * d * 4 + 2 * hkv * chunk * d * kv_elt \
        + hkv * qt * d * 4
    pairs = hkv * (qt * start + qh * chunk * (chunk + 1) // 2)
    dot = 4.0 * d * pairs
    fp32 = hkv * n * (4 * p * (1 << t_bits) + 4 * g * p) + 4.0 * pairs
    if value_elt == 1:
        fp32 += hkv * n * g * d + 4.0 * hkv * qt * start
    ops = {"bf16": dot, "fp32": fp32} if kv_elt == 2 else \
        {"fp32": dot + fp32}
    return Work(nbytes, ops, dot=dot, transcendentals=pairs)
