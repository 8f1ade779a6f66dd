"""KeyCodec registry + per-layer CachePolicy: the single dispatch point for
key-cache quantization methods (port of ``repro/core/codecs.py``).

A :class:`KeyCodec` owns everything method-specific about cached keys:
buffer allocation, encode/decode, the score path, bits accounting, writing
encoded groups straight into page-pool pages, and the fused decode and
chunk-prefill attention. The caches (``kv_cache.py`` dense,
``paged_cache.py`` pools) own only the method-agnostic machinery
(placement, the fp residual, values, lengths, masks and softmax) and
branch on two structural capabilities (``grouped``, ``quantizes``) and the
kernel capabilities (``supports_*``) — never on method names;
``tests/test_torch_codecs.py`` holds this module to being the only
string dispatch point of the package.

Registered codecs: ``"polar"`` (the hand-written kernels on the card),
the paper's baselines ``"int"`` (token-wise), ``"kivi"`` and
``"zipcache"`` (grouped), and the fp passthrough ``"none"``. The
baselines have no kernel: their encode and their dequantize-then-matmul
scores are plain PyTorch ops, as they are jnp in the JAX package, and the
paged engines reach them through the gathered decode and
:func:`~repro_torch.core.paged_cache.chunk_prefill_attention` routes —
because their capability flags say so, exactly as JAX dispatches.

Buffer layout (``lead`` is the cache's leading dims, ``(B, H)`` for dense
caches, ``(PP, H)`` for page pools): a grouped codec's ``codes`` are
``(*lead, G, g, ·)`` and every scale array is ``(*lead, G, 1|g, ·)``; the
cache keeps an fp residual for the trailing partial group. A token-wise
codec's ``codes`` are ``(*lead, T, ·)`` and every scale array
``(*lead, T, ·)``; the fp passthrough stores the keys themselves in the
model dtype with an empty scale dict.

:class:`CachePolicy` maps layer index -> :class:`QuantConfig`, so a model
can run e.g. its first layers at int8 and the rest at polar 4+4
(KVTuner-style mixed precision, DESIGN.md §10). The port allocates one
cache per layer, so a policy needs no segments to run; ``segments`` is
kept for the accounting and the JAX package's parity.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import quantizers as qz
from repro_torch.core.quantizers import QuantConfig
from repro_torch.utils import torch_dtype

#: values of ``QuantConfig.theta_stats``: per-group angle min/max, or the
#: fixed grid over (0, 2pi]
THETA_STATS = ("group", "fixed")


@dataclasses.dataclass
class CodecKeys:
    """Generic quantized-keys container: raw codec buffers + their config
    (the default :meth:`KeyCodec.container`, so a third-party codec works
    through ``quantizers.encode_keys`` / ``decode_keys``)."""

    codes: torch.Tensor
    scales: dict
    cfg: QuantConfig = None

    def decode(self, dtype=torch.float32) -> torch.Tensor:
        return self.cfg.codec.decode(self.cfg, self.codes, self.scales,
                                     dtype)


class KeyCodec:
    """Base class for key-cache codecs. Subclasses are stateless singletons
    (all per-run parameters live in :class:`QuantConfig`)."""

    name: str = ""
    grouped: bool = False            # codes carry (G, g) axes + fp residual
    quantizes: bool = True           # False => fp passthrough
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

    def container(self, cfg: QuantConfig, codes: torch.Tensor,
                  scales: dict[str, torch.Tensor]):
        """The quantized-keys container of raw buffers: the built-in
        codecs' ``quantizers`` container, :class:`CodecKeys` by default."""
        return CodecKeys(codes=codes, scales=scales, cfg=cfg)

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
        """Encode k (B, H, G*g, d) of a grouped codec and write group
        (b, n) into pool page ``pages[b, n]`` (pages (B, G) int32) in
        place. A negative page id sends its group to the scratch page (the
        pools' last), as JAX's masked scatter does: no host sync, and the
        scratch page is never read."""
        codes, scales = self.encode(cfg, k)        # (B, H, G, g|1, ·)
        scratch = codes_pool.shape[0] - 1
        idx = torch.where(pages >= 0, pages,
                          torch.full_like(pages, scratch)).reshape(-1).long()

        def put(pool, x):  # (B, H, G, a, b) -> pool rows (B*G, H, a, b)
            x = x.transpose(1, 2).reshape(-1, *x.shape[1:2], *x.shape[3:])
            pool.index_copy_(0, idx, x.to(pool.dtype))

        put(codes_pool, codes)
        for key, pool in scale_pools.items():
            put(pool, scales[key])

    def paged_decode(self, cache, q: torch.Tensor, page_table: torch.Tensor,
                     *, scale: Optional[float]) -> torch.Tensor:
        raise NotImplementedError(
            f"codec {self.name!r} has no page-native decode kernel")

    def paged_prefill(self, cache, q: torch.Tensor, k_chunk: torch.Tensor,
                      v_chunk: torch.Tensor, page_row: torch.Tensor,
                      start: int, chunk_len: int, *,
                      scale: Optional[float]) -> torch.Tensor:
        raise NotImplementedError(
            f"codec {self.name!r} has no page-native prefill kernel")


_CODECS: dict[str, KeyCodec] = {}


def register_codec(codec: KeyCodec, *, overwrite: bool = False
                   ) -> KeyCodec:
    """Register ``codec`` under ``codec.name``."""
    if not codec.name:
        raise ValueError("codec must set a non-empty .name")
    if codec.name in _CODECS and not overwrite:
        raise ValueError(f"codec {codec.name!r} already registered "
                         "(pass overwrite=True to replace)")
    _CODECS[codec.name] = codec
    return codec


def get_codec(name: str) -> KeyCodec:
    try:
        return _CODECS[name]
    except KeyError:
        raise KeyError(f"unknown key codec {name!r}; registered: "
                       f"{sorted(_CODECS)}") from None


def registered_codecs() -> dict[str, KeyCodec]:
    """Snapshot of the registry (name -> codec)."""
    return dict(_CODECS)


# ---------------------------------------------------------------------------
# Built-in codecs
# ---------------------------------------------------------------------------


class NoneCodec(KeyCodec):
    """fp passthrough: keys stored unquantized in the model dtype."""

    name = "none"
    quantizes = False

    def bits_per_element(self, cfg, head_dim):
        return 16.0

    def init_buffers(self, cfg, lead, tokens, head_dim, dtype, device):
        return torch.zeros((*lead, tokens, head_dim), dtype=dtype,
                           device=device), {}

    def encode(self, cfg, k):
        return k, {}

    def decode(self, cfg, codes, scales, dtype=torch.float32):
        return codes.to(dtype)

    def container(self, cfg, codes, scales):
        return codes


class IntCodec(KeyCodec):
    """Int-N token-wise affine quantization (per-token z, s over d)."""

    name = "int"

    def bits_per_element(self, cfg, head_dim):
        # per-token fp16 (z, s) amortized over the actual head_dim
        return float(cfg.key_bits) + 32.0 / head_dim

    def init_buffers(self, cfg, lead, tokens, head_dim, dtype, device):
        sdt = torch_dtype(cfg.scale_dtype)

        def stat():
            return torch.zeros((*lead, tokens, 1), dtype=sdt, device=device)

        return (torch.zeros((*lead, tokens, head_dim), dtype=torch.uint8,
                            device=device),
                {"scale": stat(), "zero": stat()})

    def encode(self, cfg, k):
        tk = qz.encode_int_keys(k, cfg)
        return tk.codes, {"scale": tk.scale, "zero": tk.zero}

    def decode(self, cfg, codes, scales, dtype=torch.float32):
        return qz.decode_token_keys(self.container(cfg, codes, scales), dtype)

    def container(self, cfg, codes, scales):
        return qz.TokenKeys(codes=codes, bits=cfg.key_bits, **scales)


class _GroupedCodec(KeyCodec):
    grouped = True

    def _gcount(self, cfg: QuantConfig, tokens: int) -> int:
        if tokens % cfg.group_size:
            raise ValueError(f"token capacity {tokens} not a multiple of "
                             f"group size {cfg.group_size}")
        return tokens // cfg.group_size


class KiviCodec(_GroupedCodec):
    """KIVI channel-wise quantization over token groups."""

    name = "kivi"

    def bits_per_element(self, cfg, head_dim):
        # per-channel fp16 (z, s) per group -> 32 bits / g tokens
        return float(cfg.key_bits) + 32.0 / cfg.group_size

    def init_buffers(self, cfg, lead, tokens, head_dim, dtype, device):
        gc, g, d = self._gcount(cfg, tokens), cfg.group_size, head_dim
        sdt = torch_dtype(cfg.scale_dtype)

        def stat():
            return torch.zeros((*lead, gc, 1, d), dtype=sdt, device=device)

        return (torch.zeros((*lead, gc, g, d), dtype=torch.uint8,
                            device=device),
                {"scale": stat(), "zero": stat()})

    def encode(self, cfg, k):
        ck = qz.encode_kivi_keys(k, cfg)
        return ck.codes, {"scale": ck.scale, "zero": ck.zero}

    def decode(self, cfg, codes, scales, dtype=torch.float32):
        return qz.decode_channel_keys(self.container(cfg, codes, scales),
                                      dtype)

    def container(self, cfg, codes, scales):
        return qz.ChannelKeys(codes=codes, bits=cfg.key_bits, **scales)


class ZipCacheCodec(_GroupedCodec):
    """ZipCache channel-separable token-wise quantization."""

    name = "zipcache"

    def bits_per_element(self, cfg, head_dim):
        # per-token fp16 (z, s) over d channels + an fp16 channel norm per
        # group
        return (float(cfg.key_bits) + 32.0 / head_dim
                + 16.0 / cfg.group_size)

    def init_buffers(self, cfg, lead, tokens, head_dim, dtype, device):
        gc, g, d = self._gcount(cfg, tokens), cfg.group_size, head_dim
        sdt = torch_dtype(cfg.scale_dtype)

        def z(*shape):
            return torch.zeros((*lead, gc, *shape), dtype=sdt, device=device)

        return (torch.zeros((*lead, gc, g, d), dtype=torch.uint8,
                            device=device),
                {"token_scale": z(g, 1), "token_zero": z(g, 1),
                 "channel_norm": z(1, d)})

    def encode(self, cfg, k):
        zk = qz.encode_zipcache_keys(k, cfg)
        return zk.codes, {"token_scale": zk.token_scale,
                          "token_zero": zk.token_zero,
                          "channel_norm": zk.channel_norm}

    def decode(self, cfg, codes, scales, dtype=torch.float32):
        return qz.decode_zipcache_keys(self.container(cfg, codes, scales),
                                       dtype)

    def container(self, cfg, codes, scales):
        return qz.ZipKeys(codes=codes, bits=cfg.key_bits, **scales)


def _polar_kernel_cfg(cfg: QuantConfig) -> bool:
    """The polar kernels take the "half" pairing and float32 stats; returns
    whether the angle grid is the fixed one (the encode kernel's flag)."""
    if cfg.pairing != "half" or cfg.scale_dtype != "float32":
        raise ValueError("the polar kernels take 'half' pairing and float32 "
                         f"stats, got {cfg.pairing!r} / {cfg.scale_dtype!r}")
    if cfg.theta_stats not in THETA_STATS:
        raise ValueError(f"unknown theta_stats {cfg.theta_stats!r}; "
                         f"expected one of {THETA_STATS}")
    return cfg.theta_stats == "fixed"


class PolarCodec(_GroupedCodec):
    """PolarQuant radius/angle quantization; decode attention scores
    through the angle LUT."""

    name = "polar"
    supports_fused_decode = True
    supports_paged_decode = True
    supports_paged_prefill = True

    def bits_per_element(self, cfg, head_dim):
        # (r + t)/2 payload bits per element; fp16 stat rows per channel
        # pair per group over 2*g elements: rho (z, s), plus theta (z, s)
        # unless the fixed grid is used
        stats = 2 if cfg.theta_stats == "fixed" else 4
        return (cfg.rho_bits + cfg.theta_bits) / 2.0 \
            + stats * 16.0 / (2.0 * cfg.group_size)

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
        fixed = _polar_kernel_cfg(cfg)
        codes, rs, rz, ts, tz = ops.polar_encode(
            k, r_bits=cfg.rho_bits, t_bits=cfg.theta_bits,
            group_size=cfg.group_size, fixed=fixed)
        return codes, {"rho_scale": rs, "rho_zero": rz, "theta_scale": ts,
                       "theta_zero": tz}

    def decode(self, cfg, codes, scales, dtype=torch.float32):
        return qz.decode_polar_keys(self.container(cfg, codes, scales),
                                    dtype)

    def container(self, cfg, codes, scales):
        return qz.PolarKeys(codes=codes, rho_bits=cfg.rho_bits,
                            theta_bits=cfg.theta_bits, pairing=cfg.pairing,
                            **scales)

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
        fixed = _polar_kernel_cfg(cfg)
        ops.polar_encode_pages(
            k, pages, codes_pool, scale_pools["rho_scale"],
            scale_pools["rho_zero"], scale_pools["theta_scale"],
            scale_pools["theta_zero"], r_bits=cfg.rho_bits,
            t_bits=cfg.theta_bits, fixed=fixed)

    def paged_decode(self, cache, q, page_table, *, scale):
        # page-native hot path: the kernel walks the page table and reads
        # codes/stats/values in place — no gathered dense copy. A head
        # shard plans its splits for the model's kv heads (bit-equal
        # per head to the unsharded call)
        from repro_torch.core.kv_cache import value_buffers
        from repro_torch.kernels import ops
        cfg = cache.cfg
        sc = cache.key_scales
        values, vscale, vzero = value_buffers(cache)
        return ops.polar_paged_decode_attention_full(
            q, cache.key_codes, sc["rho_scale"], sc["rho_zero"],
            sc["theta_scale"], sc["theta_zero"], cache.key_residual,
            values, page_table, cache.lengths, vscale=vscale, vzero=vzero,
            r_bits=cfg.rho_bits, t_bits=cfg.theta_bits, softmax_scale=scale,
            plan_heads=cache.kv_heads)

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
register_codec(IntCodec())
register_codec(KiviCodec())
register_codec(ZipCacheCodec())
register_codec(PolarCodec())


# ---------------------------------------------------------------------------
# Per-layer cache policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CachePolicy:
    """Layer index -> :class:`QuantConfig` map (hashable, pure config).

    ``overrides`` lists ``(layer, config)`` pairs; unlisted layers use
    ``default``. Contiguous layers sharing a config form a *segment*
    (JAX scans each segment's layers with one stacked cache; the port
    allocates a cache per layer)."""

    default: QuantConfig = QuantConfig()
    overrides: tuple[tuple[int, QuantConfig], ...] = ()

    @classmethod
    def uniform(cls, cfg: QuantConfig) -> "CachePolicy":
        return cls(default=cfg)

    @classmethod
    def per_layer(cls, overrides: dict[int, QuantConfig],
                  default: QuantConfig) -> "CachePolicy":
        return cls(default=default,
                   overrides=tuple(sorted(overrides.items())))

    @classmethod
    def first_k(cls, k: int, first: QuantConfig,
                rest: QuantConfig) -> "CachePolicy":
        """KVTuner-style split: layers ``[0, k)`` use ``first`` (e.g. int8
        for the sensitive early layers), the rest use ``rest``."""
        return cls(default=rest,
                   overrides=tuple((i, first) for i in range(k)))

    def layer_config(self, layer: int) -> QuantConfig:
        for i, q in self.overrides:
            if i == layer:
                return q
        return self.default

    @property
    def is_uniform(self) -> bool:
        return all(q == self.default for _, q in self.overrides)

    def segments(self, num_layers: int
                 ) -> tuple[tuple[int, int, QuantConfig], ...]:
        """Contiguous ``(lo, hi, config)`` runs covering ``[0, num_layers)``."""
        segs: list[tuple[int, int, QuantConfig]] = []
        for i in range(num_layers):
            q = self.layer_config(i)
            if segs and segs[-1][2] == q:
                segs[-1] = (segs[-1][0], i + 1, q)
            else:
                segs.append((i, i + 1, q))
        return tuple(segs)

    def avg_key_bits(self, num_layers: int, head_dim: int) -> float:
        """Mean logical key bits/element across the layer stack."""
        return sum(
            self.layer_config(i).key_bits_per_element(head_dim)
            for i in range(num_layers)) / max(num_layers, 1)

    def _group_sizes(self) -> set[int]:
        return {self.default.group_size} | {
            q.group_size for _, q in self.overrides}

    def max_group_size(self) -> int:
        """Largest group size across layers: the bucketing multiple of the
        dense (static) serving path, which allows mixed group sizes."""
        return max(self._group_sizes())

    def page_group_size(self) -> int:
        """The one group size shared by every layer — required by the
        paged cache, whose page size equals the quantization group size."""
        sizes = self._group_sizes()
        if len(sizes) != 1:
            raise ValueError(
                "paged serving requires one group size across all layers "
                f"(page == group); policy has {sorted(sizes)}")
        return sizes.pop()

    def map(self, fn: Callable[[QuantConfig], QuantConfig]
            ) -> "CachePolicy":
        """Apply ``fn`` to every per-layer config (smoke reductions)."""
        return CachePolicy(
            default=fn(self.default),
            overrides=tuple((i, fn(q)) for i, q in self.overrides))

