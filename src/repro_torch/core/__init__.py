"""PolarQuant core of the port: polar transform, quantizers, codec
registry and per-layer cache policy, paged KV cache, LUT scores,
SnapKV eviction."""
from repro_torch.core.quantizers import (  # noqa: F401
    ChannelKeys, PolarKeys, QuantConfig, QuantizedValues, TokenKeys,
    ZipKeys, decode_keys, decode_polar_keys, decode_values, encode_keys,
    encode_polar_keys, encode_values,
)
from repro_torch.core.codecs import (  # noqa: F401
    CachePolicy, KeyCodec, PolarCodec, get_codec, register_codec,
    registered_codecs,
)
from repro_torch.core.cache_layout import (  # noqa: F401
    LinearLayout, PageAllocator, PagedLayout, PrefixIndex, RingLayout,
    ring_segments, token_page_hashes,
)
from repro_torch.core.paged_cache import (  # noqa: F401
    PagedKVCache, chunk_prefill_attention, copy_pool_pages,
    init_paged_cache, paged_append,
    paged_decode_attention, paged_prefill, paged_prefill_attention,
    pool_page_bytes,
)
from repro_torch.core.attention import reference_attention  # noqa: F401
from repro_torch.core.lut import build_angle_table, lut_qk_scores  # noqa: F401
