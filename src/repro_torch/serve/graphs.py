"""CUDA graphs of the paged engine's decode dispatch: the port's
counterpart of the three ``jax.jit`` calls of the JAX engine's decode —
the one-token step (``repro/serve/core.py:308``, ``decode_paged`` then
``_sample``), the run-ahead horizon (``repro/serve/core.py:324``,
``decode_runahead``, DESIGN.md §18) and the speculative verify
(``repro/serve/core.py:334``, ``make_verifier``, DESIGN.md §15).

A jitted JAX step is one dispatch; the same step issued eagerly from
PyTorch is about a thousand small launches from Python, and on an H100
the host then takes longer than the device. :class:`DecodeGraphs`
captures each step once per ``(width, horizon, sampling)`` key, and each
verify once per ``("verify", width, Q, verifier)`` key, and replays it:
one ``CUDAGraph.replay()`` per step, horizon or verify. It is the
engine's one decode route: on the CPU (``eager``) it runs the same calls
eagerly and captures nothing.

* **What a graph binds.** The engine's per-layer caches (each under its
  layer's codec: a token-wise codec's has no residual, and a codec
  without a page-native kernel decodes on the gathered route, whose ops
  make no host sync either), the params, the
  session generator and, per graph, static inputs (token, the
  width-sliced page table, the active mask; a horizon also the budgets
  left and the done mask; a verify the token span (S, Q), the draft
  lengths, the table and the mask) and static outputs (logits and tokens
  of the step; the token block and the carries of a horizon; a verify's
  argmaxes (S, Q) and accepted counts (S,)). The scan verifier's graph
  also binds its shadow state (allocated by the eager run). Every input is
  copied into its static buffer on the current stream before a replay,
  so stream order keeps a replay from reading inputs meant for the next
  one. Host inputs are staged in pinned memory first: a copy from
  pageable memory may wait for the stream, which would hold a chained
  horizon's dispatch until the previous one has finished. The outputs
  are valid until the next replay of the same key; the caller copies
  what it keeps (a chained horizon's carries are read by the next
  replay's input copies, which precede it on the stream).
* **Capture against the session state.** Each key is first run eagerly
  on a side stream with every lane inactive (kernel builds, library
  loads and ``cudaFuncSetAttribute`` stay out of the capture), then
  captured on that stream. An inactive lane writes only the scratch page
  and keeps its length (an inactive verify lane commits ``n_keep = 0``
  tokens), so capturing between two steps of a live session leaves it
  untouched; the session generator is restored after the eager run and
  a capture draws nothing from it.
* **One memory pool.** All graphs of an instance share one pool; replays
  run on one stream, one after another.
* **Launch counters.** The kernel wrappers count launches in Python, so a
  capture would count launches that did not run and a replay none that
  did: a capture restores the counters it saw move and keeps the move,
  and each replay adds it (``chip_smoke.py``'s ``graphs`` phase holds
  that move to the kernels a profiled replay runs).
* **Sampling.** With ``temperature > 0`` the session generator is
  registered with the graph (``CUDAGraph.register_generator_state``):
  each replay draws from its current Philox offset and advances it as
  the eager draws would.

Nothing here falls back to eager execution on the card: a capture or
replay that fails raises. The one eager route on the card is chosen up
front, before any capture: a step that runs collectives a CUDA graph
cannot capture (a gloo group's, which stage CUDA tensors through the
host) is built with ``capturable=False`` and runs eagerly. NCCL
collectives are captured with the rest of the step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import transformer as TF

#: the kernel wrappers' launch counters (module attributes)
COUNTERS = ("launches", "launches_u8", "launches_mma", "launches_split",
            "launches_fixed", "launches_full", "launches_lse")
#: dtypes of the static inputs
_DTYPES = {"token": torch.int64, "table": torch.int32, "active": torch.bool,
           "remaining": torch.int32, "done": torch.bool,
           "tokens": torch.int64, "draft_len": torch.int32}


def kernel_modules() -> tuple:
    """The kernel wrapper modules whose counters a replay advances."""
    from repro_torch.kernels import (
        flash_prefill, paged_decode, paged_prefill, polar_attention,
        polar_encode, polar_qk,
    )
    return (polar_encode, paged_decode, flash_prefill, paged_prefill,
            polar_attention, polar_qk)


def read_counters() -> dict:
    """Every launch counter, keyed by (module, attribute)."""
    return {(mod, attr): getattr(mod, attr) for mod in kernel_modules()
            for attr in COUNTERS if hasattr(mod, attr)}


def _write_counters(counts: dict) -> None:
    for (mod, attr), n in counts.items():
        setattr(mod, attr, n)


def _add_counters(delta: dict) -> None:
    for (mod, attr), n in delta.items():
        setattr(mod, attr, getattr(mod, attr) + n)


@dataclasses.dataclass
class CapturedDecode:
    """One captured decode dispatch: its graph, static inputs and outputs,
    and the launch counts one replay adds."""

    graph: torch.cuda.CUDAGraph
    inputs: dict
    outputs: tuple
    counts: dict


class DecodeGraphs:
    """Cache of captured decode dispatches over one paged state.

    ``state`` (the per-layer paged caches), ``params`` and ``generator``
    are bound by address: the caller keeps them alive and updates them in
    place, never rebinding a buffer. ``verifier`` (``spec.make_verifier``)
    is the speculative verify a ``"verify"`` key captures.
    ``capturable=False``: the step's collectives cannot be captured, so
    every dispatch runs eagerly on the card too."""

    def __init__(self, model, params: dict, state: list,
                 generator: torch.Generator, verifier=None,
                 capturable: bool = True):
        self.model = model
        self.params = params
        self.state = state
        self.generator = generator
        self.verifier = verifier
        lengths = state[0].lengths
        self.device = lengths.device
        self.slots = lengths.shape[0]
        self.scratch = state[0].layout.scratch_page
        #: run every dispatch eagerly and capture nothing: the CPU's route
        #: (a CUDA graph needs the card), and that of a step whose
        #: collectives cannot be captured
        self.eager = self.device.type != "cuda" or not capturable
        if not self.eager:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
        self._cache: dict[tuple, CapturedDecode] = {}

    def __len__(self) -> int:
        return len(self._cache)

    def _run(self, inp: dict, horizon: int, temperature: float, top_k: int,
             eos_id: int):
        """The eager dispatch a graph captures."""
        if horizon == 1:
            logits, _ = self.model.decode_paged(
                self.params, self.state, inp["token"], inp["table"],
                inp["active"])
            return logits, TF.sample_tokens(logits, temperature, top_k,
                                            self.generator)
        return self.model.decode_runahead(
            self.params, self.state, inp["token"], inp["table"],
            inp["active"], self.generator, inp["remaining"], inp["done"],
            horizon=horizon, temperature=temperature, top_k=top_k,
            eos_id=eos_id)

    def capture(self, width: int, horizon: int, temperature: float,
                top_k: int, eos_id: int) -> Optional[CapturedDecode]:
        """The graph of one decode key, captured on first use (None when
        ``eager``)."""
        if self.eager:
            return None
        key = (width, horizon, float(temperature), int(top_k), int(eos_id))
        cap = self._cache.get(key)
        if cap is not None:
            return cap
        s, dev = self.slots, self.device
        inp = {"token": torch.zeros((s,), dtype=torch.int64, device=dev),
               "table": self._dead_table(width),
               "active": torch.zeros((s,), dtype=torch.bool, device=dev)}
        if horizon > 1:
            inp["remaining"] = torch.zeros((s,), dtype=torch.int32,
                                           device=dev)
            inp["done"] = torch.ones((s,), dtype=torch.bool, device=dev)
        return self._capture(
            key, inp, lambda: self._run(inp, horizon, temperature, top_k,
                                        eos_id), sampled=temperature > 0.0)

    def capture_verify(self, width: int, q: int) -> Optional[CapturedDecode]:
        """The graph of one speculative verify key (a span of ``q``
        columns at table width ``width``), captured on first use (None
        when ``eager``)."""
        if self.eager:
            return None
        key = ("verify", width, q, self.verifier.kind)
        cap = self._cache.get(key)
        if cap is not None:
            return cap
        s, dev = self.slots, self.device
        inp = {"tokens": torch.zeros((s, q), dtype=torch.int64, device=dev),
               "draft_len": torch.zeros((s,), dtype=torch.int32, device=dev),
               "table": self._dead_table(width),
               "active": torch.zeros((s,), dtype=torch.bool, device=dev)}
        return self._capture(key, inp, lambda: self._run_verify(inp),
                             sampled=False)

    def _dead_table(self, width: int) -> torch.Tensor:
        return torch.full((self.slots, width), self.scratch,
                          dtype=torch.int32, device=self.device)

    def _run_verify(self, inp: dict):
        """The eager verify a graph captures: (preds, n_acc)."""
        preds, n_acc, _ = self.verifier(
            self.params, self.state, inp["tokens"], inp["draft_len"],
            inp["table"], inp["active"])
        return preds, n_acc

    def _capture(self, key: tuple, inp: dict, run,
                 sampled: bool) -> CapturedDecode:
        """Run ``run`` eagerly, then capture it: the graph of ``key``."""
        dev = self.device
        rng = self.generator.get_state()
        # the eager run: every lane inactive, only the scratch page written
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):
            run()
        torch.cuda.current_stream(dev).wait_stream(self.stream)
        self.generator.set_state(rng)
        before = read_counters()
        graph = torch.cuda.CUDAGraph()
        if sampled:
            graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            out = run()
        after = read_counters()
        _write_counters(before)
        self.generator.set_state(rng)
        cap = CapturedDecode(graph=graph, inputs=inp, outputs=tuple(out),
                             counts={k: after[k] - before[k] for k in before
                                     if after[k] != before[k]})
        self._cache[key] = cap
        return cap

    def _replay(self, cap: CapturedDecode, values: dict) -> None:
        for name, x in values.items():
            x = torch.as_tensor(x)
            if x.device.type == "cpu":
                # pinned staging from the caching host allocator: the block
                # is not reused before this copy has run
                x = x.contiguous().pin_memory()
            cap.inputs[name].copy_(x, non_blocking=True)
        cap.graph.replay()
        _add_counters(cap.counts)

    def _inputs(self, values: dict) -> dict:
        return {name: torch.as_tensor(x).to(device=self.device,
                                           dtype=_DTYPES[name], copy=True)
                for name, x in values.items()}

    def _eager(self, values: dict, horizon: int, temperature: float,
               top_k: int, eos_id: int):
        return self._run(self._inputs(values), horizon, temperature, top_k,
                         eos_id)

    def step(self, width: int, temperature: float, top_k: int,
             token, table, active) -> tuple[torch.Tensor, torch.Tensor]:
        """Replay the one-token step: ``token`` (S,), ``table`` (S, width)
        int32, ``active`` (S,) bool, host arrays or tensors. Returns
        (logits (S, V), next token (S,) int32): a replay's static outputs,
        valid until the next replay of this width."""
        values = {"token": token, "table": table, "active": active}
        if self.eager:
            return self._eager(values, 1, temperature, top_k, -1)
        cap = self.capture(width, 1, temperature, top_k, -1)
        self._replay(cap, values)
        return cap.outputs

    def horizon(self, width: int, horizon: int, temperature: float,
                top_k: int, eos_id: int, token, table, active, remaining,
                done) -> tuple[torch.Tensor, ...]:
        """Replay one run-ahead horizon (inputs as in :meth:`step`, plus
        ``remaining`` (S,) int32 and ``done`` (S,) bool). Returns (tokens
        (horizon, S), token, done, remaining): a replay's static outputs,
        valid until the next replay of this key."""
        values = {"token": token, "table": table, "active": active,
                  "remaining": remaining, "done": done}
        if self.eager:
            return self._eager(values, horizon, temperature, top_k, eos_id)
        cap = self.capture(width, horizon, temperature, top_k, eos_id)
        self._replay(cap, values)
        return cap.outputs

    def verify(self, width: int, q: int, tokens, draft_len, table,
               active) -> tuple[torch.Tensor, torch.Tensor]:
        """Replay one speculative verify: ``tokens`` (S, q) int, column 0
        the real next token, then the zero-padded drafts; ``draft_len``
        (S,) int32; ``table`` (S, width) int32; ``active`` (S,) bool —
        host arrays or tensors. Commits the accepted span of every active
        lane in place. Returns (preds (S, q) int32, n_acc (S,) int32): a
        replay's static outputs, valid until the next replay of this
        key."""
        values = {"tokens": tokens, "draft_len": draft_len, "table": table,
                  "active": active}
        if self.eager:
            return self._run_verify(self._inputs(values))
        cap = self.capture_verify(width, q)
        self._replay(cap, values)
        return cap.outputs
