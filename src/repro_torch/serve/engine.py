"""ContinuousBatchingEngine: the closed-batch adapter over
:class:`~repro_torch.serve.core.EngineCore` (port of
``repro/serve/engine.py``). Submit a whole request list, drain the step
loop to quiescence, return aggregate metrics and the event stream.
Host-side only: every device dispatch lives in ``core.py``."""
from __future__ import annotations

from typing import Optional

from repro_torch.serve.core import (  # noqa: F401  (re-exports)
    EngineCore, GenerationConfig, TokenEvent,
)
from repro_torch.serve.scheduler import Request


class ContinuousBatchingEngine:
    """Continuous-batching serve engine over per-layer paged KV caches.

    ``max_slots`` concurrent requests share ``num_pages`` cache pages of
    ``group_size`` tokens each (default: fully provisioned,
    ``max_slots * ceil(max_len/g)``; fewer oversubscribe the pool — slots
    then stall, and preemption recomputes the youngest request). The
    clock advances by measured device time, so latencies compose queueing
    + compute. Runs on the card unless ``device`` names another."""

    def __init__(self, model, params, *, max_slots: int = 4,
                 max_len: int = 256, num_pages: Optional[int] = None,
                 device=None):
        self.core = EngineCore(model, params, max_slots=max_slots,
                               max_len=max_len, num_pages=num_pages,
                               device=device)

    def warmup(self, prompt_lens: list[int]) -> None:
        """Run the prefill buckets and decode widths once on throwaway
        state."""
        self.core.warmup(prompt_lens)

    def run(self, requests: list[Request],
            gen: Optional[GenerationConfig] = None) -> dict:
        """Serve ``requests`` to completion. Returns aggregate metrics, the
        completed requests (tokens + timestamps) and the ``TokenEvent``
        stream under ``"events"``."""
        core = self.core
        core.reset(gen)
        for req in sorted(requests, key=lambda r: r.arrival_time):
            core.add_request(req)
        events = list(core.events())
        res = core.result()
        res["events"] = events
        return res
