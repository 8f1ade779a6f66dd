"""KeyCodec registry: the single dispatch point for key-cache quantization
methods (port of ``repro/core/codecs.py``; this slice registers the polar
codec and the fp passthrough ``"none"``).

A :class:`KeyCodec` owns everything method-specific about cached keys:
buffer allocation, encode/decode, the score path, bits accounting, writing
encoded groups straight into page-pool pages, and the fused decode and
chunk-prefill attention. The caches (``kv_cache.py`` dense,
``paged_cache.py`` pools) own only the method-agnostic machinery
(placement, the fp residual, values, lengths, masks and softmax).

Buffer layout (``lead`` is the cache's leading dims, ``(B, H)`` for dense
caches, ``(PP, H)`` for page pools): a grouped codec's ``codes`` are
``(*lead, G, g, ·)`` and every scale array is ``(*lead, G, 1|g, ·)``; the
cache keeps an fp residual for the trailing partial group. A token-wise
codec's ``codes`` are ``(*lead, T, ·)``; the fp passthrough stores the keys
themselves in the model dtype with an empty scale dict.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import quantizers as qz
from repro_torch.core.quantizers import QuantConfig
from repro_torch.utils import torch_dtype


class KeyCodec:
    """Base class for key-cache codecs. Subclasses are stateless singletons
    (all per-run parameters live in :class:`QuantConfig`)."""

    name: str = ""
    grouped: bool = False            # codes carry (G, g) axes + fp residual
    supports_fused_decode: bool = False
    supports_paged_decode: bool = False
    supports_paged_prefill: bool = False

    def bits_per_element(self, cfg: QuantConfig, head_dim: int) -> float:
        """Logical key bits/element including quantization-stat overhead."""
        raise NotImplementedError

    def init_buffers(self, cfg: QuantConfig, lead: tuple[int, ...],
                     tokens: int, head_dim: int, dtype, device
                     ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Zero-filled ``(codes, scales)`` buffers for ``tokens`` tokens."""
        raise NotImplementedError

    def encode(self, cfg: QuantConfig, k: torch.Tensor
               ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Quantize post-RoPE keys ``(*lead, T, d)`` -> ``(codes, scales)``."""
        raise NotImplementedError

    def decode(self, cfg: QuantConfig, codes: torch.Tensor,
               scales: dict[str, torch.Tensor],
               dtype=torch.float32) -> torch.Tensor:
        """Dequantize buffers back to Cartesian keys ``(*lead, T, d)``."""
        raise NotImplementedError

    def scores(self, cfg: QuantConfig, q: torch.Tensor, codes: torch.Tensor,
               scales: dict[str, torch.Tensor]) -> torch.Tensor:
        """``q . K~`` for every cached token: q ``(*lead, Qh, d)`` ->
        ``(*lead, Qh, T)`` fp32. The default dequantizes then multiplies;
        codecs with a structured decode (polar's angle LUT) override it."""
        k_tilde = self.decode(cfg, codes, scales)
        return torch.einsum("...qd,...td->...qt", q.float(), k_tilde)

    def fused_decode(self, cache, q: torch.Tensor, *,
                     scale: Optional[float]) -> torch.Tensor:
        raise NotImplementedError(
            f"codec {self.name!r} has no fused decode kernel")

    def encode_pages(self, cfg: QuantConfig, k: torch.Tensor,
                     pages: torch.Tensor, codes_pool: torch.Tensor,
                     scale_pools: dict[str, torch.Tensor]) -> None:
        """Encode k (B, H, G*g, d) and write group (b, n) into pool page
        ``pages[b, n]`` (pages (B, G) int32) in place; negative page ids
        skip their group."""
        raise NotImplementedError

    def paged_decode(self, cache, q: torch.Tensor, page_table: torch.Tensor,
                     *, scale: Optional[float]) -> torch.Tensor:
        raise NotImplementedError(
            f"codec {self.name!r} has no page-native decode in this port")

    def paged_prefill(self, cache, q: torch.Tensor, k_chunk: torch.Tensor,
                      v_chunk: torch.Tensor, page_row: torch.Tensor,
                      start: int, chunk_len: int, *,
                      scale: Optional[float]) -> torch.Tensor:
        raise NotImplementedError(
            f"codec {self.name!r} has no page-native prefill in this port")


_CODECS: dict[str, KeyCodec] = {}


def register_codec(codec: KeyCodec) -> KeyCodec:
    """Register ``codec`` under ``codec.name``."""
    if not codec.name:
        raise ValueError("codec must set a non-empty .name")
    if codec.name in _CODECS:
        raise ValueError(f"codec {codec.name!r} already registered")
    _CODECS[codec.name] = codec
    return codec


def get_codec(name: str) -> KeyCodec:
    try:
        return _CODECS[name]
    except KeyError:
        raise KeyError(f"unknown key codec {name!r}; registered: "
                       f"{sorted(_CODECS)}") from None


class NoneCodec(KeyCodec):
    """fp passthrough: keys stored unquantized in the model dtype."""

    name = "none"

    def bits_per_element(self, cfg, head_dim):
        return 16.0

    def init_buffers(self, cfg, lead, tokens, head_dim, dtype, device):
        return torch.zeros((*lead, tokens, head_dim), dtype=dtype,
                           device=device), {}

    def encode(self, cfg, k):
        return k, {}

    def decode(self, cfg, codes, scales, dtype=torch.float32):
        return codes.to(dtype)


def _polar_kernel_cfg(cfg: QuantConfig) -> None:
    """The polar kernels take the "half" pairing and float32 stats."""
    if cfg.pairing != "half" or cfg.scale_dtype != "float32":
        raise ValueError("the polar kernels take 'half' pairing and float32 "
                         f"stats, got {cfg.pairing!r} / {cfg.scale_dtype!r}")


class PolarCodec(KeyCodec):
    """PolarQuant radius/angle quantization; decode attention scores
    through the angle LUT."""

    name = "polar"
    grouped = True
    supports_fused_decode = True
    supports_paged_decode = True
    supports_paged_prefill = True

    def bits_per_element(self, cfg, head_dim):
        # (r + t)/2 payload bits per element; four fp16 stat rows (rho and
        # theta scale/zero) per channel pair per group over 2*g elements
        return (cfg.rho_bits + cfg.theta_bits) / 2.0 \
            + 4 * 16.0 / (2.0 * cfg.group_size)

    def _gcount(self, cfg: QuantConfig, tokens: int) -> int:
        if tokens % cfg.group_size:
            raise ValueError(f"token capacity {tokens} not a multiple of "
                             f"group size {cfg.group_size}")
        return tokens // cfg.group_size

    def init_buffers(self, cfg, lead, tokens, head_dim, dtype, device):
        gc, g, p = self._gcount(cfg, tokens), cfg.group_size, head_dim // 2
        sdt = torch_dtype(cfg.scale_dtype)

        def stat():
            return torch.zeros((*lead, gc, 1, p), dtype=sdt, device=device)

        return (torch.zeros((*lead, gc, g, p), dtype=torch.uint8,
                            device=device),
                {"rho_scale": stat(), "rho_zero": stat(),
                 "theta_scale": stat(), "theta_zero": stat()})

    def encode(self, cfg, k):
        # the dense form of the encode kernel for CUDA tensors, the plain
        # encode for CPU tensors
        from repro_torch.kernels import ops
        _polar_kernel_cfg(cfg)
        codes, rs, rz, ts, tz = ops.polar_encode(
            k, r_bits=cfg.rho_bits, t_bits=cfg.theta_bits,
            group_size=cfg.group_size)
        return codes, {"rho_scale": rs, "rho_zero": rz, "theta_scale": ts,
                       "theta_zero": tz}

    def decode(self, cfg, codes, scales, dtype=torch.float32):
        return qz.decode_polar_keys(
            qz.PolarKeys(codes=codes, rho_bits=cfg.rho_bits,
                         theta_bits=cfg.theta_bits, pairing=cfg.pairing,
                         **scales), dtype)

    def scores(self, cfg, q, codes, scales):
        # the score-only LUT kernel for CUDA tensors, the gather-form LUT
        # for CPU tensors; codes (B, H, G, g, P), q (B, H, Qh, d)
        from repro_torch.kernels import ops
        _polar_kernel_cfg(cfg)
        return ops.polar_qk_scores(
            q.float().contiguous(), codes, scales["rho_scale"],
            scales["rho_zero"], scales["theta_scale"], scales["theta_zero"],
            r_bits=cfg.rho_bits, t_bits=cfg.theta_bits)

    def fused_decode(self, cache, q, *, scale):
        # LUT scores fused with the value matmul over the flushed groups,
        # merged exactly with the fp residual segment; uint8 value rows
        # travel with their row scale and zero
        from repro_torch.core.kv_cache import value_buffers
        from repro_torch.kernels import ops
        cfg = cache.cfg
        sc = cache.key_scales
        values, vscale, vzero = value_buffers(cache)
        return ops.polar_decode_attention_full(
            q, cache.key_codes, sc["rho_scale"], sc["rho_zero"],
            sc["theta_scale"], sc["theta_zero"], cache.key_residual,
            values, cache.length, vscale=vscale, vzero=vzero,
            r_bits=cfg.rho_bits, t_bits=cfg.theta_bits, softmax_scale=scale)

    def encode_pages(self, cfg, k, pages, codes_pool, scale_pools):
        # the hand-written encode kernel writes codes and stats straight
        # into pool[page] — encode and scatter fused in one launch
        from repro_torch.kernels import ops
        _polar_kernel_cfg(cfg)
        ops.polar_encode_pages(
            k, pages, codes_pool, scale_pools["rho_scale"],
            scale_pools["rho_zero"], scale_pools["theta_scale"],
            scale_pools["theta_zero"], r_bits=cfg.rho_bits,
            t_bits=cfg.theta_bits)

    def paged_decode(self, cache, q, page_table, *, scale):
        # page-native hot path: the kernel walks the page table and reads
        # codes/stats/values in place — no gathered dense copy
        from repro_torch.core.kv_cache import value_buffers
        from repro_torch.kernels import ops
        cfg = cache.cfg
        sc = cache.key_scales
        values, vscale, vzero = value_buffers(cache)
        return ops.polar_paged_decode_attention_full(
            q, cache.key_codes, sc["rho_scale"], sc["rho_zero"],
            sc["theta_scale"], sc["theta_zero"], cache.key_residual,
            values, page_table, cache.lengths, vscale=vscale, vzero=vzero,
            r_bits=cfg.rho_bits, t_bits=cfg.theta_bits, softmax_scale=scale)

    def paged_prefill(self, cache, q, k_chunk, v_chunk, page_row, start,
                      chunk_len, *, scale):
        # page-native chunk prefill: LUT scores + online softmax walk the
        # prefix pages in place; the chunk's fp causal tile shares the same
        # flash carry — no full-row gather, no dense score spill
        from repro_torch.core.kv_cache import value_buffers
        from repro_torch.kernels import ops
        cfg = cache.cfg
        sc = cache.key_scales
        values, vscale, vzero = value_buffers(cache)
        return ops.polar_paged_prefill_attention(
            q, k_chunk, v_chunk, cache.key_codes, sc["rho_scale"],
            sc["rho_zero"], sc["theta_scale"], sc["theta_zero"], values,
            page_row, start, chunk_len, vscale=vscale, vzero=vzero,
            r_bits=cfg.rho_bits, t_bits=cfg.theta_bits, softmax_scale=scale)


register_codec(NoneCodec())
register_codec(PolarCodec())

