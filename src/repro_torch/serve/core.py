"""The device-dispatch layer of the serve stack (port of
``repro/serve/core.py``): :class:`ServeEngine`, the static-batching
engine over dense caches, and :class:`EngineCore`, the continuous-batching
core over paged caches (classic whole-prompt prefill, chunked prefill and
the shared-prefix page cache).

:class:`ServeEngine` runs one shared prefill and lock-step decode; the
sampled tokens stay on the device until the loop ends (no host
synchronisation per step), and prefill and decode are timed with a device
synchronise at their ends.

In :class:`EngineCore`, one public :meth:`EngineCore.step` performs
exactly one scheduling decision + at most one device dispatch (admit —
with its whole-prompt prefill in classic mode —, one prefill chunk, or
one batched decode step) and returns structured :class:`TokenEvent`\\ s.
Requests move through::

    WAITING -> PREFILLING -> DECODING -> FINISHED
                                  \\-> PREEMPTED (-> WAITING)
    any live state -> CANCELLED
    intake over a full queue -> REJECTED        (QoS)
    WAITING with an unmeetable deadline -> SHED (QoS)

The device state (one paged cache per layer) is updated in place by each
dispatch. The engine clock advances by measured wall time around each
dispatch, which ends in the host fetch of the sampled tokens — the fetch
waits for the device, so the clock counts device time.

On the card the decode dispatch is a replayed CUDA graph
(:mod:`repro_torch.serve.graphs`): one graph per page-table width for the
one-token step, one per width for the run-ahead horizon (DESIGN.md §18:
H decode micro-steps with on-device sampling, one host sync per (H,
slots) token block, the next horizon chained off the device-resident
carries while the host reconciles the previous block). On the CPU the
same dispatches run eagerly. Prefill and chunk prefill are eager on both.
With ``spec=SpecConfig(...)`` (DESIGN.md §15) a host-side proposer
guesses up to k tokens per slot and one verify dispatch — a replayed
graph per (width, span width) on the card — scores the span and commits
only the accepted tokens. Every host synchronisation of
``repro_torch.serve`` is in this file and marked ``# sync:``.

With ``qos=QosConfig(...)`` (DESIGN.md §16) admission is weighted-fair
over tenants with token budgets, pending requests whose TTFT deadline is
unmeetable are shed, intake over a full queue is rejected, and a
degradation controller caps speculation and the prefill budget under
pool pressure (:mod:`repro_torch.serve.qos`). ``chaos=`` takes a fault
injector (:mod:`repro_torch.serve.chaos`, duck-typed here) asked once
per scheduling cycle for faults, applied through the production paths.
Both default to None, and run-ahead stays off under either.

With ``mesh=`` (a :class:`~repro_torch.launch.mesh.Mesh` of shape (1, n)
over ``("data", "model")``, DESIGN.md §17) the engine is one of n
processes that serve together: every rank holds the params whole, runs
the same host schedule and holds the same page ids, its page pools hold
one block of the KV heads, and the paged attention runs per head block
with the heads gathered over the ``model`` axis
(``distributed/serving.py``). Every input of a scheduling decision agrees
across ranks: the clock advances by rank 0's measured time. A step whose
collectives cannot be captured in a CUDA graph (gloo's) runs eagerly, the
verify included. Speculation runs under a mesh; run-ahead is taken and
stays off, as in JAX. ``ServeEngine(mesh=)`` splits the static engine's
linear caches over KV heads the same way.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core import paged_cache as pgc
from repro_torch.core.cache_layout import PagedLayout, PrefixIndex
from repro_torch.distributed import ctx as dctx
from repro_torch.distributed import serving as dsrv
from repro_torch.distributed.collectives import broadcast_host_float
from repro_torch.distributed.sharding import serving_rules
from repro_torch.launch.mesh import data_axes
from repro_torch.models import moe
from repro_torch.models import transformer as TF
from repro_torch.models.registry import Model
from repro_torch.serve.graphs import DecodeGraphs
from repro_torch.serve.qos import (
    DegradeController, QosConfig, QosState, RateEstimator,
)
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.spec import SpecConfig, make_proposer, make_verifier
from repro_torch.utils import (
    cdiv, nearest_rank_pct, pow2_bucket, resolve_device, tree_bytes,
)


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 => greedy
    top_k: int = 0
    eos_id: int = -1              # -1 => never stop early
    seed: int = 0


def _sample(logits: torch.Tensor, gen: GenerationConfig,
            generator: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy argmax at temperature <= 0; otherwise temperature scaling,
    top-k masking and Gumbel-max sampling (the categorical draw of the JAX
    engine; :func:`repro_torch.models.transformer.sample_tokens`, which
    the decode graphs capture). ``noise`` injects the Gumbel noise (tests
    feed both engines the same draws); else it is drawn from
    ``generator``."""
    return TF.sample_tokens(logits, gen.temperature, gen.top_k, generator,
                            noise)


def _check_mesh(mesh, engine: str) -> None:
    """The meshes the head-sharded engines take: (1, n) over a ``model``
    axis (a data axis > 1 is not ported, ROADMAP queue 1)."""
    if dsrv.MODEL_AXIS not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no {dsrv.MODEL_AXIS!r} axis")
    dp = [a for a in data_axes(mesh) if mesh.shape[a] > 1]
    if dp:
        raise ValueError(f"mesh {mesh.shape}: a data axis > 1 in the {engine} "
                         "engine is not ported (ROADMAP queue 1)")


#: the families whose static caches split over KV heads under a mesh
#: (``ServeEngine(mesh=)``): those ``models/transformer.py`` serves
_STATIC_MESH_FAMILIES = ("dense", "moe", "vlm")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # sync: honest clock after a dispatch


class ServeEngine:
    """Static batching: one shared prefill, lock-step decode; the whole
    batch runs until its last step. Runs on the card unless ``device``
    names another (``params`` must live there); with no GPU and no device
    named, construction raises.

    ``mesh`` (JAX's ``ServeEngine(mesh=, rules=)``, whose CLI passes
    ``serving_rules``): ``generate`` installs
    :func:`~repro_torch.distributed.sharding.serving_rules` for its batch.
    Where their ``kv_heads`` maps to the ``model`` axis (n divides the KV
    heads), each layer's linear cache holds this rank's block of the KV
    heads (``KVCache.head_shard``), #1 and #3 run on it at prefill, #5 or
    #6 at decode, and the heads are gathered over the axis before ``wo``;
    where they do not divide, every rank holds the whole caches (the GQA
    fallback). The dense, MoE and VLM families serve under a mesh; the
    hybrid, encoder-decoder and SSM families are refused, and so is a
    data axis > 1 (ROADMAP queue 1)."""

    def __init__(self, model: Model, params: dict, max_len: int,
                 device=None, mesh=None):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.device = resolve_device(device)
        self.mesh = mesh
        #: this rank's (head block, blocks) of the KV heads, or None when
        #: the caches hold every head
        self.head_shard = None
        if mesh is not None:
            fam = model.cfg.family
            if fam not in _STATIC_MESH_FAMILIES:
                raise ValueError(
                    f"ServeEngine(mesh=): the {fam!r} family under a mesh "
                    "is not ported (ROADMAP queue 1); the "
                    f"{', '.join(_STATIC_MESH_FAMILIES)} families are")
            _check_mesh(mesh, "static")
            # the kv_heads rule does not depend on the batch
            axis = serving_rules(model.cfg, mesh, 1).get("kv_heads")
            if isinstance(axis, str):
                self.head_shard = dsrv.head_block(mesh, axis)

    def _ctx(self, batch: int):
        """The sharding context of this engine's dispatches: the serving
        rules for ``batch`` rows under a mesh."""
        if self.mesh is not None:
            return dctx.use_sharding(
                self.mesh, serving_rules(self.model.cfg, self.mesh, batch))
        return contextlib.nullcontext()

    def generate(self, batch: dict,
                 gen: Optional[GenerationConfig] = None) -> dict:
        """batch: {"tokens": (B, Tp) int} (the VLM also ``"patches"``, the
        encoder-decoder ``"frames"``, each (B, frontend_tokens,
        frontend_dim)). Returns the generated tokens (B, max_new_tokens)
        as numpy, prefill and decode seconds, decode tokens/s and the
        decode state's physical bytes (in all and per layer; per layer
        None for the hybrid, encoder-decoder and SSM families).

        A linear self cache (dense, MoE, VLM, encoder-decoder) must hold
        the prompt and the appended tokens, else ``ValueError``. JAX's
        engine skips the check for the encoder-decoder family and decodes
        past the cache's capacity."""
        gen = gen if gen is not None else GenerationConfig()
        cfg = self.model.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        inputs = {"tokens": tokens}
        frontend = {"vlm": "patches", "encdec": "frames"}.get(cfg.family)
        if frontend:
            inputs[frontend] = torch.as_tensor(batch[frontend],
                                               device=self.device)
        b, tp = tokens.shape
        if (cfg.family in ("dense", "moe", "vlm", "encdec")
                and cfg.window == 0):
            # linear cache: prompt (with the frontend's tokens) + appended
            # tokens must fit (the last sampled token is never appended,
            # hence the -1); a ring cache holds any length
            tp += cfg.frontend_tokens if cfg.family == "vlm" else 0
            if tp + gen.max_new_tokens - 1 > self.max_len:
                raise ValueError(
                    f"prompt {tp} + max_new_tokens {gen.max_new_tokens} "
                    f"exceeds cache capacity {self.max_len}")
        generator = torch.Generator(device=self.device)
        generator.manual_seed(gen.seed)
        skw = ({} if self.head_shard is None
               else {"head_shard": self.head_shard})
        state = self.model.init_decode_state(b, self.max_len, self.device,
                                             **skw)
        with self._ctx(b):
            t0 = time.monotonic()
            logits, state = self.model.prefill(self.params, inputs, state)
            _sync(self.device)
            t_prefill = time.monotonic() - t0

            tok = _sample(logits, gen, generator)
            toks = [tok]
            done = torch.zeros((b,), dtype=torch.bool, device=self.device)
            t0 = time.monotonic()
            for _ in range(gen.max_new_tokens - 1):
                logits, state = self.model.decode(self.params, state, tok)
                tok = _sample(logits, gen, generator)
                if gen.eos_id >= 0:
                    done = done | (tok == gen.eos_id)
                    tok = torch.where(done,
                                      torch.full_like(tok, gen.eos_id), tok)
                toks.append(tok)
            _sync(self.device)
            t_decode = time.monotonic() - t0
        n_dec = max(gen.max_new_tokens - 1, 1)
        return {
            "tokens": torch.stack(toks, dim=1).cpu().numpy(),  # sync: out
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "tokens_per_s": b * n_dec / max(t_decode, 1e-9),
            "cache_bytes": tree_bytes(state),
            "cache_bytes_per_layer": (
                self.model.cache_layer_bytes(state)
                if self.model.cache_layer_bytes else None),
            "head_shard": self.head_shard,
        }


# ---------------------------------------------------------------------------
# Request lifecycle states and the event taxonomy
# ---------------------------------------------------------------------------

WAITING = "waiting"          # submitted, not yet holding a slot
PREFILLING = "prefilling"    # slot assigned, context not yet encoded
DECODING = "decoding"        # prefill done, producing tokens
FINISHED = "finished"        # EOS / length limit; slot + pages released
PREEMPTED = "preempted"      # pages reclaimed under pressure; requeued
CANCELLED = "cancelled"      # caller cancelled; slot + pages released
REJECTED = "rejected"        # QoS bounded-queue backpressure at intake
SHED = "shed"                # QoS deadline shed before admission


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One observable engine transition, stamped with the engine clock.

    ``token`` is the sampled token for ``first_token``/``token`` events;
    for ``preempt`` it is the *retracted* token (never fed to the model,
    re-sampled on resume). ``ordinal`` is the token's 0-based index in
    the request's output stream.

    A run-ahead horizon retires several tokens of a request from one
    dispatch: each gets its own event sharing one clock stamp, with
    ``span`` the tokens that dispatch retired for the rid and ``span_ix``
    the event's position inside the span — a one-token step is the
    degenerate ``span=1, span_ix=0``. ``reason`` says why a ``reject`` or
    ``shed`` happened (``"queue_full"``, ``"deadline_blown"``,
    ``"deadline_unmeetable"``); None otherwise."""

    kind: str
    rid: int
    t: float
    token: Optional[int] = None
    slot: int = -1
    ordinal: int = -1
    span: int = 1
    span_ix: int = 0
    reason: Optional[str] = None


class EngineCore:
    """Step-shaped continuous-batching core over per-layer paged caches.

    ``max_slots`` concurrent requests share ``num_pages`` pages of one
    quantization group each (default: fully provisioned). ``device``:
    the card unless named — with no GPU and no device named, construction
    raises. ``params`` must live on that device.

    ``prefill_chunk > 0`` prefills prompts in page-aligned chunks
    interleaved with decode steps, one chunk per cycle.
    ``prefix_cache=True`` (which implies a chunk of two pages when none is
    given) registers completed prompts' full-chunk pages in a
    :class:`PrefixIndex`; admissions that match adopt those pages and
    prefill only the tail (DESIGN.md §12). Page tables are width-sliced to
    pow2 live-page buckets.

    ``runahead = H > 1`` (DESIGN.md §18): when the horizon planner sees no
    scheduling event in the next H steps (nothing queued, no prefill due,
    no prefix cache), one dispatch runs H decode micro-steps with
    on-device sampling and EOS/budget masking, and the host syncs once
    per (H, slots) token block; the next horizon is chained off the
    device-resident carries before the previous block lands. Streams are
    those of ``runahead=0``, greedy and sampled. 0 and 1 disable it.

    ``spec=SpecConfig(mode=...)`` (DESIGN.md §15; greedy sampling only):
    each decode step asks the proposer for up to ``spec.k`` drafts per
    slot (clamped to the slot's current quantization group and budget),
    and a step with drafts runs one verify dispatch that retires 1..k+1
    tokens per slot — the span verifier on the ``"jnp"`` decode backend,
    the scan verifier otherwise (``spec/verify.py``). Streams are those
    of plain greedy decode; run-ahead stays off. An MoE model on the span
    verifier refuses a ``spec.k`` whose span widths exceed the MoE
    capacity of their span (``models/moe.py``, :func:`capacity`).

    ``prefill_budget`` is the per-cycle chunk-prefill token budget
    (default one chunk). ``qos=QosConfig(...)`` and ``chaos=`` (a
    :class:`~repro_torch.serve.chaos.ChaosInjector`) add the QoS layer and
    fault injection (DESIGN.md §16); a capped speculative span reuses the
    verify graphs of the warmup, whose span-width buckets cover every
    smaller span.

    Every decode dispatch goes through
    :class:`~repro_torch.serve.graphs.DecodeGraphs`: on the card a
    replayed CUDA graph (one per width and horizon, and per width and span
    width for the verify, bound to this engine's state), on the CPU the
    same calls eagerly.
    The device state is allocated once: :meth:`reset` zeroes it in place,
    so the graphs survive across sessions.

    ``mesh`` (DESIGN.md §17): this process's view of a (1, n) mesh over
    ``("data", "model")``, under the rules of
    :func:`~repro_torch.distributed.sharding.serving_rules`. Where they map
    ``kv_heads`` to the model axis (n divides the KV heads), the page
    pools hold this rank's head block and the paged attention runs per
    shard; otherwise every rank holds the whole pools and runs the plain
    path. Speculative decode runs as without a mesh (both verifiers, per
    head block; a draft model's dense caches hold every head on every
    rank). ``runahead > 1`` is taken and left unused, as JAX's engine
    leaves it (its horizon planner stays off under a mesh), so
    ``result()["runahead"]`` reports no horizon. A data axis > 1 raises
    (ROADMAP queue 1). ``result()["graphs"]`` says whether decode
    dispatches replay CUDA graphs."""

    def __init__(self, model: Model, params: dict, *, max_slots: int = 4,
                 max_len: int = 256, num_pages: Optional[int] = None,
                 prefix_cache: bool = False, prefill_chunk: int = 0,
                 prefill_budget: int = 0, runahead: int = 0,
                 spec: Optional[SpecConfig] = None,
                 qos: Optional[QosConfig] = None, chaos=None, device=None,
                 mesh=None):
        if model.decode_paged is None:
            raise ValueError(
                f"family {model.cfg.family!r} has no paged decode path")
        self.model = model
        self.params = params
        self.device = resolve_device(device)
        self.mesh = mesh
        # a mesh gets the serving rule set: heads and the KV page pools
        # over "model" where divisible
        self.rules = None
        if mesh is not None:
            _check_mesh(mesh, "paged")
            self.rules = serving_rules(model.cfg, mesh, max_slots)
        axis = self.rules.get("kv_heads") if self.rules else None
        #: this rank's (head block, blocks) of the KV heads, or None when
        #: the pools hold every head
        self.head_shard = (dsrv.head_block(mesh, axis)
                           if isinstance(axis, str) else None)
        # chunk prefill width-slices the slot's table row only on the
        # page-native backend (its read volume then follows the live
        # prefix); "jnp" gathers the full row, as JAX's does
        self._prefill_slicing = model.cfg.prefill_backend != "jnp"
        # page == quantization group: every layer of the policy must agree
        # on the group size (bit widths and methods may differ per layer)
        g = model.cfg.policy.page_group_size()
        pages_per_slot = cdiv(max_len, g)
        if num_pages is None:
            num_pages = max_slots * pages_per_slot
        self.layout = PagedLayout(page_size=g, num_pages=num_pages,
                                  slots=max_slots,
                                  pages_per_slot=pages_per_slot)
        self.prefix_cache = bool(prefix_cache)
        chunk = int(prefill_chunk)
        if chunk < 0:
            raise ValueError(f"prefill_chunk must be >= 0, got {chunk}")
        if self.prefix_cache and chunk == 0:
            chunk = 2 * g   # sharing requires the chunk-aligned path
        if chunk:
            chunk = cdiv(chunk, g) * g   # page-aligned chunks
        self.prefill_chunk = chunk
        self.prefill_budget = int(prefill_budget) if prefill_budget else chunk
        self.runahead = int(runahead)
        if self.runahead < 0:
            raise ValueError(f"runahead must be >= 0, got {runahead}")
        # speculative decode (DESIGN.md §15): a host-side proposer guesses
        # up to spec.k tokens per slot; one verify dispatch scores the
        # whole span and commits only accepted tokens. Greedy only —
        # reset() enforces temperature 0.
        self.spec = spec if spec is not None and spec.mode != "off" else None
        verifier = None
        if self.spec is not None:
            verifier = make_verifier(model)
            if verifier.kind == "span" and model.cfg.family == "moe":
                # the span verifier routes each column alone (t = 1, no
                # drop); JAX routes the whole span with capacity over its
                # Q tokens, which drops once Q exceeds that capacity
                over = [q for q in self._spec_q_buckets()
                        if q > moe.capacity(q, model.cfg)]
                if over:
                    raise ValueError(
                        f"spec.k {self.spec.k} gives span widths {over} "
                        f"past the MoE capacity of their span; the span "
                        f"verifier would keep assignments JAX drops")
            self._proposer = make_proposer(
                self.spec, target_cfg=model.cfg, target_model=model,
                target_params=params, max_len=self.layout.tokens_per_slot)
        # QoS (DESIGN.md §16): None takes no QoS branch. chaos is a built
        # injector, duck-typed (this module does not import serve.chaos);
        # None takes no chaos branch.
        self.qos_cfg = qos
        self.chaos = chaos
        # the session state and generator live as long as the engine: the
        # decode graphs bind their addresses
        self.state = self.model.init_paged_state(self.layout, self.device,
                                                 self.head_shard)
        self._generator = torch.Generator(device=self.device)
        # a head-sharded step gathers over the model axis: decided here,
        # before any capture, whether its collectives can be captured
        capturable = self.head_shard is None or mesh.capturable(axis)
        self._graphs = DecodeGraphs(model, params, self.state,
                                    self._generator, verifier,
                                    capturable=capturable)
        self.reset()

    # --- session lifecycle ------------------------------------------------

    def reset(self, gen: Optional[GenerationConfig] = None) -> None:
        """Start a fresh session: zeroed device state (in place — the
        buffers, and the decode graphs bound to them, are kept), new
        scheduler, clock, RNG seed and metrics."""
        self.gen = gen if gen is not None else GenerationConfig()
        if self.spec is not None:
            if self.gen.temperature > 0.0:
                raise ValueError(
                    "speculative decoding requires greedy sampling "
                    "(temperature 0): acceptance compares the target "
                    "model's argmax per position")
            self._proposer.reset()
        self.prefix = (PrefixIndex(self.layout, self.prefill_chunk)
                       if self.prefix_cache else None)
        self.qos = QosState(self.qos_cfg) if self.qos_cfg is not None \
            else None
        self.degrade = (DegradeController(self.qos_cfg)
                        if self.qos_cfg is not None and self.qos_cfg.degrade
                        else None)
        self._prefill_rate = RateEstimator() if self.qos is not None \
            else None
        self.sched = Scheduler(self.layout, prefix_index=self.prefix,
                               chunk_tokens=self.prefill_chunk, qos=self.qos)
        for cache in self.state:
            pgc.zero_cache(cache)
        s = self.layout.slots
        self.clock = 0.0
        self._generator.manual_seed(self.gen.seed)
        self._next_tok = np.zeros((s,), np.int32)
        self._lengths = np.zeros((s,), np.int64)
        self._eff_max: dict[int, int] = {}
        self._admit_seq: dict[int, int] = {}   # slot -> admission order
        self._prefilling: dict[int, dict] = {}  # slot -> {"ctx", "off"}
        self._n_admitted = 0
        self._arrivals: list[Request] = []     # sorted by arrival_time
        self.completed: list[Request] = []
        self.cancelled: list[Request] = []
        self.shed: list[Request] = []          # QoS deadline sheds
        self.rejected: list[Request] = []      # QoS queue-full rejects
        self._intake_events: list[TokenEvent] = []
        self._cycle = 0                        # chaos schedule domain
        self._quarantine_release = -1
        self._preempted_cycle = False          # degrade pressure signal
        if self.chaos is not None:
            self.chaos.reset()
        # cycle state: one cycle is the phase sequence begin -> admit* ->
        # prefill* -> decode, pumping arrivals and resetting the chunk
        # budget once per cycle (the JAX engine's replay order)
        self._phase = "begin"
        self._progressed = False
        self._budget_left = 0
        # metrics
        self._util: list[float] = []
        self._active_hist: list[int] = []
        self._step_times: list[float] = []
        self._prefill_times: list[float] = []
        self.decode_steps = 0
        self.prefill_computed = 0   # prefill tokens run through the model
        self.prefill_skipped = 0    # prefill tokens served from adoption
        self.cow_splits = 0
        self.proposer_faults = 0
        self.spec_steps = 0         # decode steps that verified >=1 draft
        self.spec_drafted = 0       # draft tokens sent to verification
        self.spec_accepted = 0      # draft tokens accepted
        self.spec_q_hist: dict[int, int] = {}   # span width -> dispatches
        # run-ahead pipeline state (DESIGN.md §18): the in-flight horizon
        # record (which carries its own optimistic per-slot budgets) and
        # the host-vs-device attribution metrics
        self._inflight: Optional[dict] = None
        self._land_t = 0.0          # wall time the last horizon landed
        self.runahead_horizons = 0
        self.runahead_tokens = 0
        self._gap_ewma: Optional[float] = None  # host overlap per horizon
        self._sync_wait_s = 0.0     # host time blocked on landing blocks
        self._overlap_s = 0.0       # host time overlapped w/ device work

    # --- request intake ---------------------------------------------------

    def add_request(self, req: Request) -> int:
        """Enqueue ``req`` for admission at ``req.arrival_time`` on the
        engine clock (insertion-ordered among equal times). Rejects
        (ValueError) a context that can never fit one slot. With QoS
        bounded-queue backpressure (``QosConfig.max_pending``), intake
        over a full queue marks the request ``REJECTED`` and queues an
        explicit ``reject`` event (``reason="queue_full"``); the rid is
        returned all the same."""
        need = self.layout.pages_for(req.context_len + 1)
        if need > self.layout.pages_per_slot:
            raise ValueError(
                f"request {req.rid}: context {req.context_len} needs "
                f"{need} pages > pages_per_slot "
                f"{self.layout.pages_per_slot}")
        if self.qos is not None and self.qos_cfg.max_pending > 0 and \
                len(self._arrivals) + len(self.sched.pending) >= \
                self.qos_cfg.max_pending:
            req.state = REJECTED
            req.t_done = self.clock
            self.rejected.append(req)
            self.qos.on_reject(req)
            self._intake_events.append(TokenEvent(
                "reject", req.rid, self.clock, reason="queue_full"))
            return req.rid
        req.state = WAITING
        i = len(self._arrivals)
        while i > 0 and self._arrivals[i - 1].arrival_time > \
                req.arrival_time:
            i -= 1
        self._arrivals.insert(i, req)
        return req.rid

    def take_intake_events(self) -> list[TokenEvent]:
        """Drain the events produced at intake (QoS rejects); :meth:`step`
        prepends them itself."""
        evs, self._intake_events = self._intake_events, []
        return evs

    def cancel(self, rid: int) -> list[TokenEvent]:
        """Cancel a request wherever it is; returns the ``cancel`` event
        ([] when ``rid`` is unknown or already finished). Host-side only:
        the slot's pages are decref'd and the slot is free at once. An
        in-flight run-ahead horizon is landed first (its token events
        precede the cancel in the returned list), so a cancelled rid never
        emits tokens after its terminal event and its pages are released
        only once the device is done writing them."""
        pre = self._reconcile_horizon() if self._inflight is not None \
            else []
        for i, r in enumerate(self._arrivals):
            if r.rid == rid:
                del self._arrivals[i]
                return pre + self._cancelled(r)
        summary = self.sched.cancel(rid)
        if summary is None:
            return pre
        if summary.slot >= 0:
            self._prefilling.pop(summary.slot, None)
            self._eff_max.pop(rid, None)
        if self.spec is not None:
            self._proposer.release(rid)
        return pre + self._cancelled(summary.req, summary.slot)

    def _cancelled(self, req: Request, slot: int = -1) -> list[TokenEvent]:
        req.state = CANCELLED
        req.t_done = self.clock
        self.cancelled.append(req)
        return [TokenEvent("cancel", req.rid, self.clock, slot=slot)]

    @property
    def has_work(self) -> bool:
        return bool(self._arrivals) or self.sched.has_work or \
            self._inflight is not None

    # --- width buckets ----------------------------------------------------

    def _decode_widths(self) -> list[int]:
        """Page-table width buckets of the decode step: powers of two
        capped at ``pages_per_slot``."""
        n = self.layout.pages_per_slot
        widths, w = [], 1
        while w < n:
            widths.append(w)
            w *= 2
        widths.append(n)
        return widths

    def _spec_q_buckets(self) -> list[int]:
        """Span-width buckets (Q = 1 bonus + drafts) of the verify
        dispatch: 1 + pow2 draft counts, capped at ``spec.k + 1`` and at
        the group size (the span clamp keeps every span inside its slot's
        current quantization group)."""
        cap = min(self.spec.k + 1, self.layout.page_size)
        out, q = [], 2
        while q < cap:
            out.append(q)
            q = 2 * (q - 1) + 1
        out.append(cap)
        return out

    def _spec_q(self, q_needed: int) -> int:
        """Smallest span-width bucket covering ``q_needed`` positions."""
        for q in self._spec_q_buckets():
            if q >= q_needed:
                return q
        return self.spec.k + 1

    def _step_width(self, pages_needed: int) -> int:
        """Smallest width bucket covering ``pages_needed`` live pages: the
        decode step reads the table only up to it, so its cost follows the
        batch's live context, not the pool capacity."""
        for w in self._decode_widths():
            if w >= pages_needed:
                return w
        return self.layout.pages_per_slot

    def _prefill_widths(self, prompt_lens: list[int]) -> list[int]:
        """Table-row widths the chunk prefill runs at: the decode buckets
        up to the largest prompt's page count when the backend slices the
        row, the full width otherwise."""
        if not self._prefill_slicing:
            return [self.layout.pages_per_slot]
        maxw = self._step_width(
            self.layout.pages_for(max(prompt_lens))
            if prompt_lens else self.layout.pages_per_slot)
        return [w for w in self._decode_widths() if w <= maxw]

    def _bucket(self, prompt_len: int) -> int:
        return min(pow2_bucket(prompt_len, self.layout.page_size),
                   self.layout.tokens_per_slot)

    def _table(self, width: Optional[int] = None) -> torch.Tensor:
        t = self.sched.alloc.table(self.device)
        return t if width is None else t[:, :width]

    def warmup(self, prompt_lens: list[int],
               gen: Optional[GenerationConfig] = None) -> None:
        """Run every prefill bucket (or chunk width) of ``prompt_lens``
        once against throwaway state (kernel builds and library
        initialisation stay out of the measurements), sampling with a
        throwaway generator — the session's is left alone, as the JAX
        engine's warmup leaves its key. Then capture the decode graph of
        every width (and the run-ahead horizon's, and the verify's of
        every span width) under ``gen``'s sampling (default: the
        session's) against the session state, every lane inactive
        (nothing to capture on the CPU)."""
        gen = gen if gen is not None else self.gen
        with self._ctx():
            self._warmup(prompt_lens, gen)

    def _warmup(self, prompt_lens: list[int], gen: GenerationConfig) -> None:
        state = self.model.init_paged_state(self.layout, self.device,
                                            self.head_shard)
        rng = torch.Generator(device=self.device)
        rng.manual_seed(0)
        row = self._table()[0]
        if self.prefill_chunk:
            c = self.prefill_chunk
            toks = torch.zeros((1, c), dtype=torch.int64, device=self.device)
            for w in self._prefill_widths(prompt_lens):
                # a width-w row holds at most w pages of real tokens
                logits, _ = self.model.prefill_paged_chunk(
                    self.params, toks, state, 0, row[:w], 0,
                    min(c, w * self.layout.page_size))
                _sample(logits, gen, rng).cpu()  # sync: warmup barrier
        else:
            for tp in sorted({self._bucket(t) for t in prompt_lens}):
                toks = torch.zeros((1, tp), dtype=torch.int64,
                                   device=self.device)
                logits, _ = self.model.prefill_paged(self.params, toks, state,
                                                     0, row, tp)
                _sample(logits, gen, rng).cpu()  # sync: warmup barrier
        del state
        # no horizon under a mesh: the planner never engages there
        horizons = [1] + ([self.runahead] if self.runahead > 1
                          and self.mesh is None else [])
        for w in self._decode_widths():
            for h in horizons:
                self._graphs.capture(w, h, gen.temperature, gen.top_k,
                                     gen.eos_id)
            if self.spec is not None:
                for q in self._spec_q_buckets():
                    self._graphs.capture_verify(w, q)

    # --- the step loop ----------------------------------------------------

    def step(self) -> list[TokenEvent]:
        """One scheduling decision + at most one device dispatch, in cycle
        priority order: admit the next admissible request (adopting prefix
        pages; classic mode also runs its whole-prompt prefill here), run
        one prefill chunk (chunked mode, under the cycle budget), or run
        one batched decode step (or run-ahead horizon) over all
        decode-ready slots — or recompute-preempt the youngest admission
        when every slot stalls on a dry pool. While a horizon is in
        flight, the step chains the next one and lands the block instead.
        Idle with scheduled arrivals jumps the clock; idle with no work
        returns ``[]``. Intake events (QoS rejects) come first."""
        intake = self.take_intake_events()
        with self._ctx():
            events = self._step()
        return intake + events if intake else events

    def _ctx(self):
        """The sharding context of this engine's dispatches (none without
        a mesh)."""
        if self.rules is not None:
            return dctx.use_sharding(self.mesh, self.rules)
        return contextlib.nullcontext()

    def _tick(self, t0: float) -> float:
        """Advance the clock by the wall time since ``t0`` and return the
        advance; under a mesh by rank 0's measurement, so that every
        rank's scheduling decisions (arrivals, QoS budgets, deadlines)
        read one clock and the ranks issue matching collectives."""
        dt = time.monotonic() - t0
        if self.mesh is not None:
            dt = broadcast_host_float(dt, self.mesh, dsrv.MODEL_AXIS)
        self.clock += dt
        return dt

    def _step(self) -> list[TokenEvent]:
        if self._inflight is not None:
            # a run-ahead horizon is in flight: chain the next horizon off
            # its device-resident carries while it computes, then land it
            # and reconcile its events (DESIGN.md §18). The phase machine
            # only runs once the pipeline drains.
            return self._advance_runahead()
        if self._phase == "begin":
            self._pump_arrivals()
            if not self.sched.has_work:
                if not self._arrivals:
                    return []   # fully idle: wait for add_request()
                # idle engine: jump the clock to the next arrival
                self.clock = max(self.clock, self._arrivals[0].arrival_time)
                self._pump_arrivals()
            self._cycle += 1
            self._progressed = False
            self._budget_left = self.prefill_budget
            if self.qos is not None:
                self.qos.refill(self.clock)
            if self.degrade is not None:
                self.degrade.update(self.sched.utilization(),
                                    self._preempted_cycle)
                self._preempted_cycle = False
                self._budget_left = self.degrade.prefill_budget(
                    self.prefill_budget)
                if self.degrade.evict_ahead:
                    # drop index-only prefix pages so live decode keeps
                    # ~1 page of headroom per active slot, ahead of the
                    # preemption path
                    want = (self.sched.num_active
                            - self.sched.alloc.free_pages)
                    if want > 0:
                        self.sched.reclaim(want)
            self._phase = "admit"
            if self.chaos is not None:
                events = self._apply_chaos()
                if events:
                    return events   # faults end the begin phase

        if self._phase == "admit":
            if self.qos is not None:
                shed_evs = self._shed_unmeetable()
                if shed_evs:
                    return shed_evs
            req = self.sched.admissible()
            if req is not None:
                return self._admit(req)
            if not self.sched.active:
                # nothing running and the queue head can't fit: wait for
                # arrivals (clock jump) or fail loudly
                self._phase = "begin"
                if self.sched.pending and self._arrivals:
                    self.clock = max(self.clock,
                                     self._arrivals[0].arrival_time)
                    return []
                if self.sched.pending:
                    if self._quarantine_release >= 0:
                        # a chaos quarantine (not the pool size) holds the
                        # pages; it lifts at a known cycle — spin
                        return []
                    if self.qos is not None:
                        # an idle engine's clock stands still, so a tenant
                        # bucket blocking the whole queue would never
                        # refill: jump to the earliest affordable time
                        # (deadlines blown by the wait shed next cycle)
                        t = self.qos.next_affordable_time(
                            self.sched.pending, self.clock)
                        if t is not None:
                            self.clock = max(self.clock, t)
                            return []
                    raise RuntimeError("pool cannot fit a single pending "
                                       "request (num_pages too small)")
                return []
            self._phase = "prefill"

        if self._phase == "prefill":
            if self._budget_left > 0 and self._prefilling:
                return self._prefill_one_chunk()
            self._phase = "decode"

        self._phase = "begin"   # decode (or preempt) ends the cycle
        return self._decode_step()

    def _pump_arrivals(self) -> None:
        while self._arrivals and \
                self._arrivals[0].arrival_time <= self.clock:
            self.sched.submit(self._arrivals.pop(0))

    # --- QoS and chaos seams (DESIGN.md §16) ------------------------------

    def _apply_chaos(self) -> list[TokenEvent]:
        """The one chaos seam: once per cycle, apply the injector's
        declarative faults through production paths (allocator
        quarantine, the engine clock, the real cancel path)."""
        if 0 <= self._quarantine_release <= self._cycle:
            self.sched.alloc.release_quarantine()
            self._quarantine_release = -1
        events: list[TokenEvent] = []
        for act in self.chaos.actions(self._cycle):
            if act[0] == "exhaust":
                self.sched.alloc.quarantine(self.sched.alloc.free_pages)
                self._quarantine_release = self._cycle + int(act[1])
            elif act[0] == "slow":
                self.clock += float(act[1])
            elif act[0] == "cancel_storm":
                live = [r.rid for r in self.sched.pending] + \
                    [r.rid for r in self.sched.active.values()]
                for rid in self.chaos.pick_victims(live, float(act[1])):
                    events += self.cancel(rid)
        return events

    def _shed_unmeetable(self) -> list[TokenEvent]:
        """Deadline-aware admission control: drop pending requests whose
        TTFT deadline is already blown or provably unmeetable given the
        queue ahead of them and the measured prefill rate
        (:meth:`QosState.unmeetable`), each with a ``shed`` event."""
        inflight = sum(len(cur["ctx"]) - cur["off"]
                       for cur in self._prefilling.values())
        doomed = self.qos.unmeetable(self.sched.pending, self.clock,
                                     self._prefill_rate.rate, inflight)
        events: list[TokenEvent] = []
        for req, reason in doomed:
            self.sched.cancel(req.rid)
            req.state = SHED
            req.t_done = self.clock
            self.shed.append(req)
            self.qos.on_shed(req)
            events.append(TokenEvent("shed", req.rid, self.clock,
                                     reason=reason))
        return events

    def _admit(self, req: Request) -> list[TokenEvent]:
        """Assign a slot, adopt prefix hits, reserve pages. Chunked mode
        queues the context for interleaved chunk prefill; classic mode
        prefills the whole context in one dispatch and samples the first
        token (a preempted request resumes by prefilling its full
        context either way)."""
        slot = self.sched.admit(req)
        req.state = PREFILLING
        self._admit_seq[slot] = self._n_admitted
        self._n_admitted += 1
        ctx_toks = req.context_tokens()
        tl = len(ctx_toks)
        self._eff_max[req.rid] = req.done_tokens + min(
            req.max_new_tokens - req.done_tokens,
            self.layout.tokens_per_slot - tl + 1)
        events = [TokenEvent("admit", req.rid, self.clock, slot=slot)]
        if self.prefill_chunk:
            # adopted prefix pages skip their prefill compute; chunks
            # cover [prefix_hit_tokens, tl)
            self._prefilling[slot] = {"ctx": ctx_toks,
                                      "off": req.prefix_hit_tokens}
            self._lengths[slot] = req.prefix_hit_tokens
            self.prefill_skipped += req.prefix_hit_tokens
            return events
        toks = np.zeros((1, self._bucket(tl)), np.int64)
        toks[0, :tl] = ctx_toks
        t0 = time.monotonic()
        logits, self.state = self.model.prefill_paged(
            self.params, torch.as_tensor(toks, device=self.device),
            self.state, slot, self._table()[slot], tl)
        # the host fetch waits for the device: the clock counts its time
        tok = _sample(logits, self.gen, self._generator)
        tok0 = int(tok.cpu()[0])  # sync: classic prefill's first token
        dt = self._tick(t0)
        self._prefill_times.append(dt)
        if self._prefill_rate is not None:
            self._prefill_rate.observe(tl, dt)
        self.prefill_computed += tl
        return events + self._take_first_token(slot, tok0, tl)

    def _prefill_one_chunk(self) -> list[TokenEvent]:
        """One prefill chunk for the oldest mid-prefill admission (FCFS);
        the slot joins the decode batch the step after its final chunk."""
        slot = min(self._prefilling, key=self._admit_seq.__getitem__)
        cur = self._prefilling[slot]
        ctx_toks, off = cur["ctx"], cur["off"]
        tl = len(ctx_toks)
        c = self.prefill_chunk
        clen = min(c, tl - off)
        toks = np.zeros((1, c), np.int64)
        toks[0, :clen] = ctx_toks[off:off + clen]
        row = self._table()[slot]
        if self._prefill_slicing:
            # width-slice the row to the pages this chunk touches: the
            # kernel then reads O(live prefix), not O(capacity)
            row = row[:self._step_width(
                cdiv(off + clen, self.layout.page_size))]
        t0 = time.monotonic()
        logits, self.state = self.model.prefill_paged_chunk(
            self.params, torch.as_tensor(toks, device=self.device),
            self.state, slot, row, off, clen)
        self._progressed = True
        self._budget_left -= clen
        self.prefill_computed += clen
        cur["off"] = off + clen
        self._lengths[slot] = off + clen
        if cur["off"] >= tl:
            # final chunk: its last-token logits seed decode; the host
            # fetch waits for the device
            tok = _sample(logits, self.gen, self._generator)
            tok0 = int(tok.cpu()[0])  # sync: final chunk's first token
            dt = self._tick(t0)
            self._prefill_times.append(dt)
            if self._prefill_rate is not None:
                self._prefill_rate.observe(clen, dt)
            del self._prefilling[slot]
            self.sched.register_prefix(slot)
            return self._take_first_token(slot, tok0, tl)
        _sync(self.device)   # honest clock
        dt = self._tick(t0)
        self._prefill_times.append(dt)
        if self._prefill_rate is not None:
            self._prefill_rate.observe(clen, dt)
        return []

    def _take_first_token(self, slot: int, tok0: int,
                          tl: int) -> list[TokenEvent]:
        """Record a request's first sampled token after its prefill."""
        req = self.sched.active[slot]
        req.state = DECODING
        first = req.t_first_token is None
        if req.t_admitted is None:
            req.t_admitted = req.t_first_token = self.clock
        req.out_tokens.append(tok0)
        self._next_tok[slot] = tok0
        self._lengths[slot] = tl
        if self.qos is not None:
            self.qos.on_tokens(req.tenant, 1)
        # a preemption-resume re-prefill is not the stream's first token
        events = [TokenEvent("first_token" if first else "token",
                             req.rid, self.clock, token=tok0, slot=slot,
                             ordinal=req.done_tokens - 1)]
        if (self.gen.eos_id >= 0 and tok0 == self.gen.eos_id) or \
                req.done_tokens >= self._eff_max[req.rid]:
            events += self._finish(slot)
        return events

    def _finish(self, slot: int) -> list[TokenEvent]:
        req = self.sched.active[slot]
        req.state = FINISHED
        req.t_done = self.clock
        self._eff_max.pop(req.rid, None)
        if self.spec is not None:
            self._proposer.release(req.rid)
        self.completed.append(self.sched.finish(slot))
        return [TokenEvent("finish", req.rid, self.clock, slot=slot)]

    def _decode_step(self) -> list[TokenEvent]:
        """Batched decode over the non-stalled, fully prefilled slots — a
        speculative verify when some slot has drafts, a run-ahead horizon
        when the planner allows one; recompute-preemption when nothing can
        run and no chunk progressed this cycle."""
        sched, g = self.sched, self.layout.page_size
        if not sched.active:
            return []   # cancellation emptied the cycle mid-flight
        drafts: dict[int, list[int]] = {}
        want_runahead = self._runahead_want()
        # a horizon reserves its whole span's pages up front; a shortfall
        # (pool pressure) drops this step back to the one-token dispatch,
        # which knows how to stall and preempt
        spans = ({sl: self.runahead for sl in sched.active}
                 if want_runahead else None)
        if self.spec is not None:
            # proposer work bills to the session clock: a draft-model
            # proposer runs real forwards and must not get them for free
            t0 = time.monotonic()
            drafts = self._propose_drafts()
            self._tick(t0)
            spans = {sl: 1 + len(d) for sl, d in drafts.items()}
        stalled = set(sched.ensure_pages(self._lengths,
                                         skip=self._prefilling.keys(),
                                         spans=spans))
        if self.spec is not None:
            # shed drafts the pool could not back: the accepted span must
            # stay inside the slot's allocated pages
            for sl, d in drafts.items():
                cap = (sched.alloc.slot_pages(sl) * g
                       - int(self._lengths[sl]) - 1)
                if len(d) > max(cap, 0):
                    del d[max(cap, 0):]
        step_slots = [sl for sl in sched.active
                      if sl not in stalled and sl not in self._prefilling]

        # copy-on-write guard: never append into a shared page. Chunk-
        # aligned adoption makes this a no-op in steady state (adopted
        # pages all precede the write frontier), but it is the invariant
        # that keeps sharing safe under any adoption policy (DESIGN.md
        # §12). A speculative span may reach further pages, so every page
        # the commit could touch is checked.
        if step_slots and (self.prefix_cache or self.cow_splits):
            safe = []
            for sl in step_slots:
                lo = int(self._lengths[sl]) // g
                hi = (int(self._lengths[sl]) + len(drafts.get(sl, ()))) // g
                ok = True
                for pidx in range(lo, hi + 1):
                    if not (pidx < sched.alloc.slot_pages(sl) and
                            sched.alloc.refcount(
                                sched.alloc.page_at(sl, pidx)) > 1):
                        continue
                    if not sched.alloc.can_alloc(1):
                        sched.reclaim(1)
                    if not sched.alloc.can_alloc(1):
                        ok = False   # no page to split into: stall a step
                        break
                    src, dst = sched.alloc.cow(sl, pidx)
                    self.state = self.model.copy_pages(self.state, src, dst)
                    self.cow_splits += 1
                if ok:
                    safe.append(sl)
            step_slots = safe

        if not step_slots:
            if self._progressed:
                return []   # chunk prefill advanced; next cycle retries
            # every slot needs a page and the pool is dry: recompute-
            # preempt the most recent admission so the rest make progress
            victim = max(sched.active, key=self._admit_seq.__getitem__)
            vreq = sched.active[victim]
            if vreq.preemptions >= 64:
                raise RuntimeError(
                    "request thrashing on preemption — pool too small to "
                    "finish any request")
            # mid-prefill slots can't be victims: chunk work always
            # progresses when any exist, and progress skips this branch
            assert victim not in self._prefilling
            retracted = vreq.out_tokens.pop() if vreq.out_tokens else None
            self._eff_max.pop(vreq.rid, None)
            if self.spec is not None:
                self._proposer.release(vreq.rid)
            sched.preempt(victim)
            vreq.state = PREEMPTED
            self._preempted_cycle = True
            return [TokenEvent("preempt", vreq.rid, self.clock,
                               token=retracted, slot=victim)]
        if self.spec is not None and any(drafts.get(sl)
                                         for sl in step_slots):
            return self._spec_dispatch(step_slots, drafts)
        if want_runahead and self._runahead_ready(step_slots):
            return self._runahead_dispatch(step_slots)
        return self._decode_dispatch(step_slots)

    def _decode_dispatch(self, step_slots: list[int]) -> list[TokenEvent]:
        """The one-token decode dispatch over ``step_slots``: a replay of
        the width's step graph (``decode_paged`` and the sampling; the
        same two calls eagerly on the CPU)."""
        sched, g = self.sched, self.layout.page_size
        s = self.layout.slots
        mask = np.zeros((s,), bool)
        mask[step_slots] = True
        # width-slice the page table to the live pages of this step's
        # batch: the decode step then reads O(live tokens)
        w = self._step_width(
            max(int(self._lengths[sl]) // g + 1 for sl in step_slots))
        tok = self._next_tok.astype(np.int64)
        t0 = time.monotonic()
        _, nxt = self._graphs.step(w, self.gen.temperature, self.gen.top_k,
                                   tok, sched.alloc.table()[:, :w], mask)
        # one host fetch per step; it waits for the device
        toks = nxt.cpu().numpy()  # sync: one-token step's token fetch
        step_s = self._tick(t0)
        self.decode_steps += 1
        self._step_times.append(step_s)
        self._util.append(sched.utilization())
        self._active_hist.append(len(step_slots))

        events = []
        for sl in step_slots:
            self._lengths[sl] += 1
            req = sched.active[sl]
            t = int(toks[sl])
            req.out_tokens.append(t)
            self._next_tok[sl] = t
            if self.qos is not None:
                self.qos.on_tokens(req.tenant, 1)
            events.append(TokenEvent("token", req.rid, self.clock, token=t,
                                     slot=sl, ordinal=req.done_tokens - 1))
            if (self.gen.eos_id >= 0 and t == self.gen.eos_id) or \
                    req.done_tokens >= self._eff_max[req.rid]:
                events += self._finish(sl)
        return events

    # --- run-ahead decode (DESIGN.md §18) ---------------------------------

    def _runahead_want(self) -> bool:
        """Horizon-planner gate: run-ahead engages only when the next H
        step boundaries are provably event-free — nothing queued to
        admit, no prefill chunk due, and none of the subsystems that
        decide per step in play: speculation (drafts are proposed per
        step), QoS and chaos (shedding, budgets and faults act per cycle),
        mesh placement and prefix sharing (its COW guard decides per
        step), JAX's gate term for term. Every other configuration takes
        the one-token dispatch unchanged."""
        return (self.runahead > 1 and self.spec is None
                and self.qos is None and self.chaos is None
                and self.mesh is None and not self.prefix_cache
                and not self._prefilling and not self._arrivals
                and not self.sched.pending)

    def _runahead_ready(self, step_slots: list[int]) -> bool:
        """Per-slot hazard check after page reservation: every active
        slot decodes this step and holds pages covering the tokens its
        horizon can append (EOS and budget hazards are masked on the
        device; a page shortfall means pool pressure, so fall back to the
        one-token path, which can stall and preempt)."""
        sched, g = self.sched, self.layout.page_size
        if len(step_slots) != len(sched.active):
            return False
        for sl in step_slots:
            req = sched.active[sl]
            need = int(self._lengths[sl]) + min(
                self.runahead, self._eff_max[req.rid] - req.done_tokens)
            if sched.alloc.slot_pages(sl) * g < need:
                return False
        return True

    def _runahead_dispatch(self, step_slots: list[int]) -> list[TokenEvent]:
        """Dispatch one fresh horizon from host-known carries (next
        tokens, per-slot budgets). Returns no events: the host does not
        wait for the block — its tokens reconcile when it lands (the next
        step, or a cancel arriving mid-flight)."""
        s = self.layout.slots
        mask = np.zeros((s,), bool)
        mask[step_slots] = True
        rem = np.zeros((s,), np.int32)
        for sl in step_slots:
            req = self.sched.active[sl]
            rem[sl] = self._eff_max[req.rid] - req.done_tokens
        self._dispatch_horizon(
            step_slots, self._next_tok.astype(np.int64),
            np.zeros((s,), bool), rem, mask,
            {sl: int(rem[sl]) for sl in step_slots},
            {sl: int(self._lengths[sl]) for sl in step_slots})
        return []

    def _chain_dispatch(self, live: list[int]) -> None:
        """Dispatch the next horizon straight off the in-flight one's
        device-resident carries (final token, done mask, budgets) — no
        host sync in between, so the device stays busy while the host
        reconciles the previous block's events."""
        blk = self._inflight
        tok, done, rem = blk["carry"]
        self._dispatch_horizon(live, tok, done, rem, blk["mask"],
                               {sl: blk["ahead_rem"][sl] for sl in live},
                               {sl: blk["opt_len"][sl] for sl in live})

    def _dispatch_horizon(self, slots, tok, done, rem, mask,
                          host_rem: dict, host_len: dict) -> None:
        g, h = self.layout.page_size, self.runahead
        cap = self.layout.tokens_per_slot
        gen = self.gen
        # the width covers every page the horizon can touch (appends and
        # attention reads up to len + H, clamped to the slot capacity)
        w = self._step_width(max(
            (min(host_len[sl] + h, cap) - 1) // g + 1 for sl in slots))
        # the generator state before the horizon's draws: a block whose
        # lanes all freeze early rewinds to it (_reconcile_block)
        rng = self._generator.get_state() if gen.temperature > 0.0 else None
        t0 = time.monotonic()
        toks, tok, done, rem = self._graphs.horizon(
            w, h, gen.temperature, gen.top_k, gen.eos_id, tok,
            self.sched.alloc.table()[:, :w], mask, rem, done)
        # start the block's copy to the host now: landing it then waits
        # for this horizon alone, not for a successor chained behind it
        host, ready = self._fetch_async(toks)
        self._inflight = {
            "host": host, "ready": ready, "slots": list(slots),
            "rem": host_rem, "len": host_len,
            # optimistic carries for chaining: a slot that survives its
            # horizon advanced exactly min(h, rem) tokens; one that
            # finished is excluded from the next chain (budget) or
            # skipped at reconcile (EOS — its device lane froze)
            "ahead_rem": {sl: max(host_rem[sl] - h, 0) for sl in slots},
            "opt_len": {sl: host_len[sl] + min(h, host_rem[sl])
                        for sl in slots},
            "carry": (tok, done, rem), "mask": mask, "rng": rng,
            "rng_set": False, "t0": t0, "t_disp": time.monotonic(),
        }

    def _advance_runahead(self) -> list[TokenEvent]:
        """The pipeline's per-step beat: chain the next horizon off the
        in-flight one's device carries when the planner still allows it,
        then land the in-flight block and reconcile its events. Chaining
        happens *before* the landing sync, so host reconciliation
        overlaps the next horizon's device compute."""
        old = self._inflight
        chained = False
        if self._runahead_want():
            live = [sl for sl in old["slots"]
                    if old["ahead_rem"][sl] > 0 and sl in self.sched.active]
            if live:
                g = self.layout.page_size
                opt = self._lengths.copy()
                for sl in live:
                    opt[sl] = old["opt_len"][sl]
                dead = [sl for sl in self.sched.active if sl not in live]
                stalled = set(self.sched.ensure_pages(
                    opt, skip=dead,
                    spans={sl: self.runahead for sl in live}))
                ok = not stalled and all(
                    self.sched.alloc.slot_pages(sl) * g >=
                    old["opt_len"][sl] + min(self.runahead,
                                             old["ahead_rem"][sl])
                    for sl in live)
                if ok:
                    self._chain_dispatch(live)
                    chained = True
        if not chained:
            self._inflight = None
        return self._reconcile_block(old)

    def _reconcile_horizon(self) -> list[TokenEvent]:
        """Land the in-flight horizon now (a cancel arriving mid-flight):
        sync, emit its events, drain the pipeline."""
        blk, self._inflight = self._inflight, None
        return self._reconcile_block(blk)

    def _reconcile_block(self, blk: dict) -> list[TokenEvent]:
        """Land one horizon's (H, S) token block — the single host sync
        for its H micro-steps — and replay the host-side bookkeeping the
        one-token loop does per step: per-token ordinals, horizon-shared
        clock stamps with (span, span_ix), truncation at EOS or budget,
        finish and page reclamation. Under sampling, rewind the generator
        to the state after the block's live micro-steps when its lanes
        all froze early (the one-token loop stops drawing there)."""
        sched, h = self.sched, self.runahead
        t_sync = time.monotonic()
        gap = t_sync - blk["t_disp"]   # host work overlapped with device
        self._overlap_s += gap
        self._gap_ewma = gap if self._gap_ewma is None else \
            0.8 * self._gap_ewma + 0.2 * gap
        # the one fetch per H tokens
        if blk["ready"] is not None:
            blk["ready"].synchronize()  # sync: a horizon block lands
        toks = blk["host"].numpy()  # sync: none left, the copy has landed
        now = time.monotonic()
        self._sync_wait_s += now - t_sync
        # wall time is partitioned across pipelined horizons: each bills
        # from the later of its dispatch and the previous landing
        step_s = now - max(blk["t0"], self._land_t)
        self._land_t = now
        self.clock += step_s
        events: list[TokenEvent] = []
        live = n_live = 0
        for sl in blk["slots"]:
            req = sched.active.get(sl)
            if req is None or req.state != DECODING:
                continue   # finished/cancelled before this block landed
            live += 1
            rem = blk["rem"][sl]
            emit: list[int] = []
            finished = False
            for j in range(min(h, rem)):
                t = int(toks[j, sl])
                emit.append(t)
                if self.gen.eos_id >= 0 and t == self.gen.eos_id:
                    finished = True
                    break
            if len(emit) >= rem:
                finished = True   # budget bound inside the horizon
            span = len(emit)
            # the lane was live for exactly ``span`` micro-steps
            n_live = max(n_live, span)
            # device lengths advanced once per live micro-step, so host
            # and device lengths agree for every surviving slot; a
            # finishing slot's pages are reclaimed here, the first host
            # step after the block lands
            self._lengths[sl] += span
            for j, t in enumerate(emit):
                req.out_tokens.append(t)
                events.append(TokenEvent(
                    "token", req.rid, self.clock, token=t, slot=sl,
                    ordinal=req.done_tokens - 1, span=span, span_ix=j))
            self._next_tok[sl] = emit[-1]
            self.runahead_tokens += span
            if finished:
                events += self._finish(sl)
        if blk["rng"] is not None and n_live < h and not blk["rng_set"]:
            # every lane froze after n_live micro-steps: the one-token
            # loop drew n_live times; a chained successor is all frozen
            # and must not move the generator again
            self._rewind_generator(blk["rng"], n_live)
            if self._inflight is not None:
                self._inflight["rng_set"] = True
        self.runahead_horizons += 1
        self.decode_steps += h
        self._step_times.append(step_s / h)
        self._util.append(sched.utilization())
        self._active_hist.append(live)
        return events

    def _fetch_async(self, x: torch.Tensor
                     ) -> tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """Start copying ``x`` to the host: (the host tensor, the event
        that marks the copy done — None on the CPU, where ``x`` is the
        host tensor). The pinned block comes from the caching host
        allocator, which does not reuse it before the copy has run."""
        if x.device.type != "cuda":
            return x, None
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return host, ready

    def _rewind_generator(self, state: torch.Tensor, draws: int) -> None:
        """Set the session generator to ``state`` advanced by ``draws``
        sampling draws (one ``torch.rand`` of the logits' shape each)."""
        self._generator.set_state(state)
        shape = (self.layout.slots, self.model.cfg.vocab_size)
        for _ in range(draws):
            torch.rand(shape, generator=self._generator, device=self.device)

    # --- speculative decode (DESIGN.md §15) -------------------------------

    def _propose_drafts(self) -> dict[int, list[int]]:
        """Up to ``spec.k`` draft tokens per decode-ready slot, clamped so
        (a) a fully accepted span never overshoots the request's budget
        (the bonus token is always emitted on top of the drafts) and (b)
        the span never extends past the slot's current quantization group
        (``span <= g - length % g``) — the invariant the span verifier
        and the fused span commit rely on (at most the LAST position can
        flush a group), and the reason a verify dispatch runs at the
        one-token step's table width. A proposer exception (a real bug or
        an injected fault) never takes the engine down: the slot gets no
        drafts and the fault is counted. Under QoS degradation k is halved
        per level (0 at level 3)."""
        g = self.layout.page_size
        k = (self.degrade.spec_k(self.spec.k) if self.degrade is not None
             else self.spec.k)
        drafts: dict[int, list[int]] = {}
        for sl, req in self.sched.active.items():
            if sl in self._prefilling:
                continue
            want = min(k, self._eff_max[req.rid] - req.done_tokens - 1,
                       g - int(self._lengths[sl]) % g - 1)
            d: list = []
            if want > 0:
                try:
                    if self.chaos is not None:
                        self.chaos.maybe_fail_proposer()
                    d = self._proposer.propose(req, want)
                except Exception:
                    self.proposer_faults += 1
                    d = []
            drafts[sl] = [int(t) for t in d[:max(want, 0)]]
        return drafts

    def _spec_dispatch(self, step_slots: list[int],
                       drafts: dict[int, list[int]]) -> list[TokenEvent]:
        """One verify dispatch retiring 1..k+1 tokens per stepped slot: a
        replay of the (width, span width) verify graph (on the CPU the
        verifier eagerly). Column 0 of the span is the step's real next
        token, columns 1..k the zero-padded drafts; the emitted tokens are
        the argmaxes of column 0 and of the accepted drafts — what plain
        greedy decode emits over the next ``n_acc + 1`` steps."""
        sched, g = self.sched, self.layout.page_size
        s = self.layout.slots
        q = self._spec_q(1 + max(len(drafts.get(sl, ()))
                                 for sl in step_slots))
        mask = np.zeros((s,), bool)
        mask[step_slots] = True
        toks = np.zeros((s, q), np.int64)
        toks[:, 0] = self._next_tok
        dlen = np.zeros((s,), np.int32)
        for sl in step_slots:
            d = drafts.get(sl, [])
            toks[sl, 1:1 + len(d)] = d
            dlen[sl] = len(d)
        # the span clamp keeps every real span inside its slot's current
        # page, so the one-token step's width covers it; padding columns
        # past it reach only don't-care positions
        w = self._step_width(
            max(int(self._lengths[sl]) // g + 1 for sl in step_slots))
        t0 = time.monotonic()
        preds, n_acc = self._graphs.verify(w, q, toks, dlen,
                                           sched.alloc.table()[:, :w], mask)
        # one host fetch per verify (argmaxes and accept counts); it
        # waits for the device
        out = torch.cat([preds, n_acc[:, None]], 1).cpu().numpy()  # sync: verify
        preds, n_acc = out[:, :q], out[:, q]
        step_s = self._tick(t0)
        self.decode_steps += 1
        self.spec_steps += 1
        self.spec_q_hist[q] = self.spec_q_hist.get(q, 0) + 1
        self._step_times.append(step_s)
        self._util.append(sched.utilization())
        self._active_hist.append(len(step_slots))

        events = []
        for sl in step_slots:
            req = sched.active[sl]
            n = int(n_acc[sl])
            self.spec_drafted += int(dlen[sl])
            self.spec_accepted += n
            self._proposer.feedback(req.rid, int(dlen[sl]), n)
            # emit the argmax chain, truncating at EOS or the budget (the
            # clamp lets the budget bind only at the last span position)
            emit: list[int] = []
            finished = False
            for j in range(n + 1):
                t = int(preds[sl, j])
                emit.append(t)
                if (self.gen.eos_id >= 0 and t == self.gen.eos_id) or \
                        req.done_tokens + len(emit) >= \
                        self._eff_max[req.rid]:
                    finished = True
                    break
            span = len(emit)
            if self.qos is not None:
                self.qos.on_tokens(req.tenant, span)
            for j, t in enumerate(emit):
                req.out_tokens.append(t)
                events.append(TokenEvent(
                    "token", req.rid, self.clock, token=t, slot=sl,
                    ordinal=req.done_tokens - 1, span=span, span_ix=j))
            # the device lengths advanced by n + 1 (the accepted span);
            # when EOS truncates the emission the slot finishes and its
            # pages are reclaimed, so the host length is moot
            self._lengths[sl] += n + 1
            self._next_tok[sl] = emit[-1]
            if finished:
                events += self._finish(sl)
        return events

    # --- session results --------------------------------------------------

    def events(self) -> Iterator[TokenEvent]:
        """Drive :meth:`step` until the engine has no work, yielding each
        event as it happens."""
        while self.has_work:
            yield from self.step()

    def result(self) -> dict:
        """Aggregate session metrics plus the completed request objects."""
        completed = self.completed
        total_tokens = sum(r.done_tokens for r in completed)
        lats = sorted(r.latency() for r in completed)
        ttfts = sorted((r.t_first_token or 0.0) - r.arrival_time
                       for r in completed)
        step_times = self._step_times
        cache_bytes = tree_bytes(self.state)
        res = {
            "requests": completed,
            "total_tokens": total_tokens,
            "wall_s": self.clock,
            "tokens_per_s": total_tokens / max(self.clock, 1e-9),
            "p50_latency_s": nearest_rank_pct(lats, 50),
            "p99_latency_s": nearest_rank_pct(lats, 99),
            "p50_ttft_s": nearest_rank_pct(ttfts, 50),
            "p99_ttft_s": nearest_rank_pct(ttfts, 99),
            "decode_steps": self.decode_steps,
            # per token step: a horizon bills its wall time / H
            "decode_step_s_mean": float(np.mean(step_times)) if step_times
            else 0.0,
            "decode_step_s_p50": float(np.median(step_times)) if step_times
            else 0.0,
            # prefill dispatches: whole prompts, or chunks in chunked mode
            "prefill_s_total": float(np.sum(self._prefill_times)),
            "prefills": len(self._prefill_times),
            "mean_active_slots": float(np.mean(self._active_hist))
            if self._active_hist else 0.0,
            "mean_page_utilization": float(np.mean(self._util))
            if self._util else 0.0,
            "cache_bytes": cache_bytes,
            "prefill_chunk": self.prefill_chunk,
            "prefill_backend": self.model.cfg.prefill_backend,
            "prefix_cache": self.prefix_cache,
            "prefill_tokens_computed": self.prefill_computed,
            "prefill_tokens_skipped": self.prefill_skipped,
            "prefix_hit_rate": self.prefill_skipped / max(
                self.prefill_skipped + self.prefill_computed, 1),
            "adopted_pages": self.sched.adopted_pages,
            "fresh_pages": self.sched.fresh_pages,
            "cow_splits": self.cow_splits,
            "cancelled_requests": self.cancelled,
            "n_cancelled": len(self.cancelled),
            "shed_requests": self.shed,
            "n_shed": len(self.shed),
            "rejected_requests": self.rejected,
            "n_rejected": len(self.rejected),
            "decode_graphs": len(self._graphs) if self._graphs is not None
            else 0,
            "graphs": not self._graphs.eager,
            "head_shard": self.head_shard,
            "proposer_faults": self.proposer_faults,
        }
        if self.qos is not None:
            res["qos"] = {
                **self.qos.stats(),
                "prefill_rate_est": self._prefill_rate.rate,
                "degrade": (self.degrade.stats()
                            if self.degrade is not None else None),
            }
        if self.chaos is not None:
            res["chaos"] = self.chaos.stats()
        if self.runahead > 1:
            # host-vs-device attribution of the pipeline: the dispatch-gap
            # EWMA is host time per horizon overlapped with device work;
            # sync_wait is what the host still spends blocked on landing
            # blocks
            res["runahead"] = {
                "h": self.runahead,
                "horizons": self.runahead_horizons,
                "tokens": self.runahead_tokens,
                "dispatch_gap_ewma_s": self._gap_ewma or 0.0,
                "host_overlap_s": self._overlap_s,
                "sync_wait_s": self._sync_wait_s,
            }
        if self.spec is not None:
            res["spec"] = {
                "mode": self.spec.mode,
                "k": self.spec.k,
                "steps": self.spec_steps,
                "drafted_tokens": self.spec_drafted,
                "accepted_tokens": self.spec_accepted,
                "acceptance_rate": self.spec_accepted / max(
                    self.spec_drafted, 1),
                "mean_accepted_per_step": self.spec_accepted / max(
                    self.spec_steps, 1),
                # verify dispatches per span-width bucket (the port's
                # addition: each bucket is its own graph)
                "dispatches_by_q": dict(sorted(self.spec_q_hist.items())),
            }
        if self.prefix is not None:
            page_bytes = sum(pgc.pool_page_bytes(c) for c in self.state)
            res["pool_page_bytes"] = page_bytes
            res["prefix_pool_bytes_saved"] = \
                self.sched.adopted_pages * page_bytes
            res["prefix_index"] = {
                "entries": len(self.prefix), "queries": self.prefix.queries,
                "evictions": self.prefix.evictions,
            }
        return res
