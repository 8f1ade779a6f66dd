"""ContinuousBatchingEngine: the closed-batch adapter over
:class:`~repro_torch.serve.core.EngineCore` (port of
``repro/serve/engine.py``). Submit a whole request list, drain the step
loop to quiescence, return aggregate metrics and the event stream.
Host-side only: every device dispatch lives in ``core.py``."""
from __future__ import annotations

from typing import Optional

from repro_torch.serve.core import (  # noqa: F401  (re-exports)
    EngineCore, GenerationConfig, ServeEngine, TokenEvent,
)
from repro_torch.serve.scheduler import Request


class ContinuousBatchingEngine:
    """Continuous-batching serve engine over per-layer paged KV caches.

    ``max_slots`` concurrent requests share ``num_pages`` cache pages of
    ``group_size`` tokens each (default: fully provisioned,
    ``max_slots * ceil(max_len/g)``; fewer oversubscribe the pool — slots
    then stall, and preemption recomputes the youngest request). The
    clock advances by measured device time, so latencies compose queueing
    + compute. Runs on the card unless ``device`` names another.

    **Chunked prefill** (``prefill_chunk > 0``): prompts are prefilled in
    page-aligned chunks interleaved with decode steps under a per-cycle
    token budget (``prefill_budget``, default one chunk).

    **Shared-prefix page reuse** (``prefix_cache=True``, implies chunked
    prefill): completed prompts register their full-chunk pages in a
    content-hash :class:`~repro_torch.core.cache_layout.PrefixIndex`;
    admissions matching an indexed prefix adopt those pages at refcount+1
    and prefill only the tail — the same greedy streams as the unshared
    chunked run (DESIGN.md §12).

    **Run-ahead decode** (``runahead=H > 1``, DESIGN.md §18): in
    decode-bound stretches where the horizon planner predicts no
    scheduling event, the core dispatches H decode micro-steps —
    on-device sampling and EOS/budget masking — per device call,
    pipelines the next horizon while a block is in flight, and reconciles
    TokenEvents when each (H, slots) block lands. Streams equal those of
    ``runahead=0``, greedy and sampled; prefix-cache sessions keep the
    one-token dispatch.

    **Speculative decode** (``spec=SpecConfig(...)``, DESIGN.md §15,
    greedy only): a proposer guesses up to k tokens per slot and one
    verify dispatch retires 1..k+1 tokens — the streams of plain greedy
    decode.

    **QoS / chaos** (DESIGN.md §16): ``qos=QosConfig(...)`` for
    weighted-fair admission, tenant token budgets, TTFT-deadline
    shedding, bounded-queue rejects and graceful degradation;
    ``chaos=ChaosInjector(ChaosConfig(...))`` for deterministic fault
    injection. Both default to None (the FCFS engine).

    On the card each decode dispatch (one-token step, horizon or verify)
    is a replayed CUDA graph, one per page-table width (and span width);
    :meth:`warmup` captures them up front.

    **Mesh** (``mesh=``, DESIGN.md §17): one of the processes
    of a (1, n) mesh; its page pools hold its block of the KV heads and
    the paged attention runs per head block (see
    :class:`~repro_torch.serve.core.EngineCore`)."""

    def __init__(self, model, params, *, max_slots: int = 4,
                 max_len: int = 256, num_pages: Optional[int] = None,
                 prefix_cache: bool = False, prefill_chunk: int = 0,
                 prefill_budget: int = 0, runahead: int = 0, spec=None,
                 qos=None, chaos=None, device=None, mesh=None):
        self.core = EngineCore(
            model, params, max_slots=max_slots, max_len=max_len,
            num_pages=num_pages, prefix_cache=prefix_cache,
            prefill_chunk=prefill_chunk, prefill_budget=prefill_budget,
            runahead=runahead, spec=spec, qos=qos, chaos=chaos,
            device=device, mesh=mesh)

    @property
    def prefill_chunk(self) -> int:
        return self.core.prefill_chunk

    @property
    def prefix_cache(self) -> bool:
        return self.core.prefix_cache

    @property
    def runahead(self) -> int:
        return self.core.runahead

    def warmup(self, prompt_lens: list[int],
               gen: Optional[GenerationConfig] = None) -> None:
        """Run the prefill buckets (or chunk widths) once on throwaway
        state and prepare every decode width (on the card: capture its
        graphs under ``gen``'s sampling, default the session's)."""
        self.core.warmup(prompt_lens, gen)

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
