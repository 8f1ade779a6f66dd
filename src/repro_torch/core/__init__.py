"""PolarQuant core of the port: polar transform, quantizers, codec
registry, paged KV cache, LUT scores."""
from repro_torch.core.quantizers import (  # noqa: F401
    PolarKeys, QuantConfig, QuantizedValues, decode_polar_keys,
    decode_values, encode_polar_keys, encode_values,
)
from repro_torch.core.codecs import (  # noqa: F401
    KeyCodec, PolarCodec, get_codec, register_codec,
)
from repro_torch.core.cache_layout import PageAllocator, PagedLayout  # noqa: F401
from repro_torch.core.paged_cache import (  # noqa: F401
    PagedKVCache, init_paged_cache, paged_append, paged_decode_attention,
    paged_prefill,
)
from repro_torch.core.attention import reference_attention  # noqa: F401
from repro_torch.core.lut import build_angle_table, lut_qk_scores  # noqa: F401
