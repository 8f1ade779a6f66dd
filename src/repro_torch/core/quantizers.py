"""KV-cache quantizer math for the polar codec (port of
``repro/core/quantizers.py``; the int, KIVI and ZipCache quantizers come
in a later slice).

All quantizers operate on tensors shaped ``(..., T, d)``. Group-wise
methods require ``T % group_size == 0``; the cache layer owns the fp
residual for the trailing partial group.

Conventions (DESIGN.md §8):

* PolarQuant uses a *mid-rise* uniform quantizer: ``s = (max-min)/2^b``,
  ``code = floor((x-z)/s)``, ``x~ = (code + 1/2) * s + z``.
* Value quantization uses the *mid-tread* form: ``s = (max-min)/(2^b - 1)``,
  ``code = round((x-z)/s)``, ``x~ = code*s + z``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core import polar
from repro_torch.utils import torch_dtype

_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Cache-quantization policy (hashable, pure configuration)."""

    method: str = "polar"            # this slice registers "polar" only
    rho_bits: int = 4                # polar radius bits (r)
    theta_bits: int = 4              # polar angle bits (t)
    value_bits: int = 0              # 0 => values stay fp
    group_size: int = 128            # tokens per quantization group
    pairing: str = "half"            # RoPE pairing convention
    scale_dtype: str = "float32"
    residual_dtype: str = "bfloat16"

    @property
    def codec(self):
        """The registered :class:`~repro_torch.core.codecs.KeyCodec` for
        ``method``."""
        from repro_torch.core.codecs import get_codec  # codecs imports us
        return get_codec(self.method)


# ---------------------------------------------------------------------------
# Generic affine helpers
# ---------------------------------------------------------------------------


def affine_encode(x: torch.Tensor, bits: int, dim: int,
                  mode: Literal["midrise", "midtread"],
                  scale_dtype: torch.dtype = torch.float32):
    """Quantize ``x`` along ``dim`` (stats reduced over it, keepdim).

    Returns (codes uint8, scale, zero)."""
    x32 = x.float()
    mn = torch.amin(x32, dim=dim, keepdim=True)
    mx = torch.amax(x32, dim=dim, keepdim=True)
    levels = (1 << bits) if mode == "midrise" else (1 << bits) - 1
    scale = torch.clamp_min((mx - mn) / levels, _EPS)
    if mode == "midrise":
        q = torch.floor((x32 - mn) / scale)
    else:
        q = torch.round((x32 - mn) / scale)
    codes = torch.clamp(q, 0, (1 << bits) - 1).to(torch.uint8)
    return codes, scale.to(scale_dtype), mn.to(scale_dtype)


def affine_decode(codes: torch.Tensor, scale: torch.Tensor,
                  zero: torch.Tensor,
                  mode: Literal["midrise", "midtread"]) -> torch.Tensor:
    c = codes.float()
    if mode == "midrise":
        c = c + 0.5
    return c * scale.float() + zero.float()


def _group(x: torch.Tensor, g: int) -> torch.Tensor:
    """(..., T, d) -> (..., G, g, d). Requires T % g == 0."""
    *lead, t, d = x.shape
    if t % g:
        raise ValueError(f"token count {t} not divisible by group size {g}")
    return x.reshape(*lead, t // g, g, d)


def _ungroup(x: torch.Tensor) -> torch.Tensor:
    *lead, gcount, g, d = x.shape
    return x.reshape(*lead, gcount * g, d)


# ---------------------------------------------------------------------------
# PolarQuant keys
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PolarKeys:
    """Quantized key groups in polar representation.

    ``codes`` packs ``(rho_code << theta_bits) | theta_code`` into one uint8
    per channel pair."""

    codes: torch.Tensor        # (..., G, g, P) uint8
    rho_scale: torch.Tensor    # (..., G, 1, P)
    rho_zero: torch.Tensor     # (..., G, 1, P)
    theta_scale: torch.Tensor  # (..., G, 1, P)
    theta_zero: torch.Tensor   # (..., G, 1, P)
    rho_bits: int = 4
    theta_bits: int = 4
    pairing: str = "half"

    def rho_codes(self) -> torch.Tensor:
        return self.codes >> self.theta_bits

    def theta_codes(self) -> torch.Tensor:
        return self.codes & ((1 << self.theta_bits) - 1)


def encode_polar_keys(k: torch.Tensor, cfg: QuantConfig) -> PolarKeys:
    """Quantize post-RoPE keys ``(..., T, d)`` into :class:`PolarKeys`."""
    if cfg.rho_bits + cfg.theta_bits > 8:
        raise ValueError("rho_bits + theta_bits must be <= 8 for packed codes")
    sdt = torch_dtype(cfg.scale_dtype)
    rho, theta = polar.to_polar(k, cfg.pairing)          # (..., T, P)
    rc, rs, rz = affine_encode(_group(rho, cfg.group_size), cfg.rho_bits,
                               dim=-2, mode="midrise", scale_dtype=sdt)
    tc, ts, tz = affine_encode(_group(theta, cfg.group_size), cfg.theta_bits,
                               dim=-2, mode="midrise", scale_dtype=sdt)
    codes = (rc << cfg.theta_bits) | tc
    return PolarKeys(codes=codes, rho_scale=rs, rho_zero=rz, theta_scale=ts,
                     theta_zero=tz, rho_bits=cfg.rho_bits,
                     theta_bits=cfg.theta_bits, pairing=cfg.pairing)


def decode_polar_keys(pk: PolarKeys,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dequantize back to Cartesian keys ``(..., T, d)``."""
    rho = affine_decode(pk.rho_codes(), pk.rho_scale, pk.rho_zero, "midrise")
    theta = affine_decode(pk.theta_codes(), pk.theta_scale, pk.theta_zero,
                          "midrise")
    return _ungroup(polar.from_polar(rho, theta, pk.pairing)).to(dtype)


# ---------------------------------------------------------------------------
# Values (token-wise, KIVI §2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QuantizedValues:
    codes: torch.Tensor   # (..., T, d) uint8
    scale: torch.Tensor   # (..., T, 1)
    zero: torch.Tensor    # (..., T, 1)
    bits: int = 4


def encode_values(v: torch.Tensor, bits: int,
                  scale_dtype: str = "float32") -> QuantizedValues:
    c, s, z = affine_encode(v, bits, dim=-1, mode="midtread",
                            scale_dtype=torch_dtype(scale_dtype))
    return QuantizedValues(codes=c, scale=s, zero=z, bits=bits)


def decode_values(qv: QuantizedValues,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return affine_decode(qv.codes, qv.scale, qv.zero, "midtread").to(dtype)
