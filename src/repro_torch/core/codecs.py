"""KeyCodec registry: the single dispatch point for key-cache quantization
methods (port of ``repro/core/codecs.py``; this slice registers the polar
codec only).

A :class:`KeyCodec` owns everything method-specific about cached keys:
buffer allocation, encode/decode, writing encoded groups straight into
page-pool pages, and the page-native decode attention. The
paged cache owns only the method-agnostic machinery (page placement, the
fp residual, values, lengths).

Buffer layout (``lead`` is the cache's leading dims, ``(PP, H)`` for page
pools): a grouped codec's ``codes`` are ``(*lead, G, g, ·)`` and every
scale array is ``(*lead, G, 1|g, ·)``; the cache keeps an fp residual for
the trailing partial group.
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
    supports_paged_decode: bool = False

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


class PolarCodec(KeyCodec):
    """PolarQuant radius/angle quantization; decode attention scores
    through the angle LUT."""

    name = "polar"
    grouped = True
    supports_paged_decode = True

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
        pk = qz.encode_polar_keys(k, cfg)
        return pk.codes, {"rho_scale": pk.rho_scale, "rho_zero": pk.rho_zero,
                          "theta_scale": pk.theta_scale,
                          "theta_zero": pk.theta_zero}

    def decode(self, cfg, codes, scales, dtype=torch.float32):
        return qz.decode_polar_keys(
            qz.PolarKeys(codes=codes, rho_bits=cfg.rho_bits,
                         theta_bits=cfg.theta_bits, pairing=cfg.pairing,
                         **scales), dtype)

    def encode_pages(self, cfg, k, pages, codes_pool, scale_pools):
        # the hand-written encode kernel writes codes and stats straight
        # into pool[page] — encode and scatter fused in one launch
        from repro_torch.kernels import ops
        if cfg.pairing != "half" or cfg.scale_dtype != "float32":
            raise ValueError("the paged polar encode takes 'half' pairing "
                             "and float32 stats")
        ops.polar_encode_pages(
            k, pages, codes_pool, scale_pools["rho_scale"],
            scale_pools["rho_zero"], scale_pools["theta_scale"],
            scale_pools["theta_zero"], r_bits=cfg.rho_bits,
            t_bits=cfg.theta_bits)

    def paged_decode(self, cache, q, page_table, *, scale):
        # page-native hot path: the kernel walks the page table and reads
        # codes/stats/values in place — no gathered dense copy
        from repro_torch.kernels import ops
        cfg = cache.cfg
        sc = cache.key_scales
        return ops.polar_paged_decode_attention_full(
            q, cache.key_codes, sc["rho_scale"], sc["rho_zero"],
            sc["theta_scale"], sc["theta_zero"], cache.key_residual,
            cache.value_fp, page_table, cache.lengths, r_bits=cfg.rho_bits,
            t_bits=cfg.theta_bits, softmax_scale=scale)


register_codec(PolarCodec())
