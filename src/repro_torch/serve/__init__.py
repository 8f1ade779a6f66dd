"""Serving over the paged quantized KV cache: ``core.py`` owns every
device dispatch, ``scheduler.py`` slots and pages host-side, ``engine.py``
the batch-replay driver."""
from repro_torch.serve.core import (  # noqa: F401
    EngineCore, GenerationConfig, TokenEvent,
)
from repro_torch.serve.engine import ContinuousBatchingEngine  # noqa: F401
from repro_torch.serve.scheduler import (  # noqa: F401
    CancelSummary, Request, Scheduler,
)
