"""Serving over the quantized KV caches: ``core.py`` owns every device
dispatch (the static ``ServeEngine`` over dense caches and the
continuous-batching ``EngineCore`` over paged caches), ``scheduler.py``
slots and pages host-side, ``engine.py`` the batch-replay driver and
``api.py`` the streaming front door. ``qos.py`` (SLA-aware admission and
graceful degradation) and ``chaos.py`` (deterministic fault injection)
are host-side policy modules (DESIGN.md §16), both optional."""
from repro_torch.serve.chaos import (  # noqa: F401
    ChaosConfig, ChaosError, ChaosInjector,
)
from repro_torch.serve.core import (  # noqa: F401
    EngineCore, GenerationConfig, ServeEngine, TokenEvent,
)
from repro_torch.serve.api import (  # noqa: F401
    StreamingEngine, check_event_stream, stream_latency_stats,
)
from repro_torch.serve.engine import ContinuousBatchingEngine  # noqa: F401
from repro_torch.serve.qos import (  # noqa: F401
    DegradeController, QosConfig, QosState, goodput_under_sla,
)
from repro_torch.serve.scheduler import (  # noqa: F401
    CancelSummary, Request, Scheduler,
)
