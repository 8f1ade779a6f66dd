"""Deterministic fault injection for the serving stack (DESIGN.md §16;
port of ``repro/serve/chaos.py``, which the port copies rather than
imports).

Host-side only — no torch in this module — and **inert by construction**
when disabled: ``EngineCore(chaos=None)`` takes no chaos branch, and an
injector whose schedule is empty observes the engine without perturbing
it (both held to a plain engine in ``tests/test_torch_chaos.py``).

The engine exposes exactly one injection seam: at the start of every
scheduling *cycle* it asks :meth:`ChaosInjector.actions` what to do, and
inside :meth:`~repro_torch.serve.core.EngineCore._propose_drafts` it calls
:meth:`ChaosInjector.maybe_fail_proposer` within the same try/except
that guards a *real* proposer bug. The injector never touches engine
state itself — it returns declarative actions (``("exhaust", n)``,
``("slow", s)``, ``("cancel_storm", frac)``) that the core applies
through the same scheduler/allocator paths normal operation uses, so
every fault exercises production code. ``core.py`` does not import this
module (the seam is duck-typed).

Faults are scheduled by **cycle number** (one engine scheduling cycle ==
one pass of admit/prefill/decode), which is deterministic for a fixed
workload; randomized choices (storm victims, proposer failures) come
from the injector's own seeded numpy generator, never the engine's — so a
chaos run is exactly reproducible from ``(workload, ChaosConfig)``.

Spec-string form::

    exhaust@8          quarantine every free page at cycle 8 (held for
                       ``exhaust_steps`` cycles — decode stalls, the
                       preemption path fires)
    slow@5:0.05        inject a 50 ms slow step at cycle 5
    cancel@12:0.5      cancel a random half of live requests at cycle 12
    proposer@0.3       each proposer call fails with probability 0.3

joined with commas: ``"exhaust@8,cancel@12:0.5,proposer@0.1"``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


class ChaosError(RuntimeError):
    """The injected failure type (proposer faults raise it)."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Deterministic fault schedule. Empty tuples / zero rates = no
    faults (an injector over this config is provably inert)."""

    seed: int = 0
    #: cycles at which every currently-free page is quarantined
    exhaust_at: Tuple[int, ...] = ()
    #: cycles a quarantine is held before the pages return
    exhaust_steps: int = 4
    #: cycles at which a synthetic slow step is injected
    slow_at: Tuple[int, ...] = ()
    slow_s: float = 0.05
    #: cycles at which a cancel storm fires
    cancel_at: Tuple[int, ...] = ()
    #: fraction of live (pending + active) requests each storm cancels
    cancel_frac: float = 0.5
    #: per-call probability that the speculative proposer raises
    proposer_fail_rate: float = 0.0

    def __post_init__(self):
        if self.exhaust_steps < 1:
            raise ValueError("exhaust_steps must be >= 1")
        if not (0.0 <= self.cancel_frac <= 1.0):
            raise ValueError("cancel_frac must be in [0, 1]")
        if not (0.0 <= self.proposer_fail_rate <= 1.0):
            raise ValueError("proposer_fail_rate must be in [0, 1]")
        if self.slow_s < 0:
            raise ValueError("slow_s must be >= 0")

    @staticmethod
    def parse(spec: str, seed: int = 0) -> "ChaosConfig":
        """Parse the spec-string syntax (see the module docstring)."""
        exhaust, slow, cancel = [], [], []
        kw: dict = {"seed": seed}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            name, _, arg = part.partition("@")
            if name == "exhaust":
                cyc, _, hold = arg.partition(":")
                exhaust.append(int(cyc))
                if hold:
                    kw["exhaust_steps"] = int(hold)
            elif name == "slow":
                cyc, _, secs = arg.partition(":")
                slow.append(int(cyc))
                if secs:
                    kw["slow_s"] = float(secs)
            elif name == "cancel":
                cyc, _, frac = arg.partition(":")
                cancel.append(int(cyc))
                if frac:
                    kw["cancel_frac"] = float(frac)
            elif name == "proposer":
                kw["proposer_fail_rate"] = float(arg)
            else:
                raise ValueError(f"unknown chaos fault {name!r} in {spec!r}")
        return ChaosConfig(exhaust_at=tuple(exhaust), slow_at=tuple(slow),
                           cancel_at=tuple(cancel), **kw)


class ChaosInjector:
    """Stateful fault source over a :class:`ChaosConfig`. One injector serves
    one engine session; :meth:`reset` rewinds it for a fresh session so
    two sessions over the same workload inject identical faults."""

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self.reset()

    def reset(self) -> None:
        self._rng = np.random.default_rng(self.cfg.seed)
        self.exhausts = 0
        self.slow_steps = 0
        self.cancel_storms = 0
        self.storm_cancels = 0
        self.proposer_faults = 0
        self.proposer_calls = 0

    # --- the cycle seam ----------------------------------------------------

    def actions(self, cycle: int) -> List[tuple]:
        """Declarative faults for this cycle, applied by the core:
        ``("exhaust", hold_cycles)`` — quarantine every free page;
        ``("slow", seconds)`` — advance the clock without work;
        ``("cancel_storm", fraction)`` — cancel that fraction of live
        requests (victims picked via :meth:`pick_victims`)."""
        acts: List[tuple] = []
        if cycle in self.cfg.exhaust_at:
            self.exhausts += 1
            acts.append(("exhaust", self.cfg.exhaust_steps))
        if cycle in self.cfg.slow_at:
            self.slow_steps += 1
            acts.append(("slow", self.cfg.slow_s))
        if cycle in self.cfg.cancel_at:
            self.cancel_storms += 1
            acts.append(("cancel_storm", self.cfg.cancel_frac))
        return acts

    def pick_victims(self, rids: List[int], frac: float) -> List[int]:
        """Deterministic storm victims: at least one, chosen from the
        sorted live rids by the injector's own generator."""
        if not rids:
            return []
        rids = sorted(rids)
        k = max(1, int(round(frac * len(rids))))
        picked = self._rng.choice(len(rids), size=min(k, len(rids)),
                                  replace=False)
        self.storm_cancels += len(picked)
        return [rids[i] for i in sorted(picked)]

    # --- the proposer seam -------------------------------------------------

    def maybe_fail_proposer(self) -> None:
        """Called inside the engine's proposer try/except; raises
        :class:`ChaosError` with the configured probability."""
        if self.cfg.proposer_fail_rate <= 0:
            return
        self.proposer_calls += 1
        if self._rng.random() < self.cfg.proposer_fail_rate:
            self.proposer_faults += 1
            raise ChaosError("injected proposer failure")

    # --- introspection -----------------------------------------------------

    def stats(self) -> dict:
        return {
            "exhausts": self.exhausts,
            "slow_steps": self.slow_steps,
            "cancel_storms": self.cancel_storms,
            "storm_cancels": self.storm_cancels,
            "proposer_faults": self.proposer_faults,
            "proposer_calls": self.proposer_calls,
        }
