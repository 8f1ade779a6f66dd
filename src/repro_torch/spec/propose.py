"""Draft proposers: guess the next k tokens for a decoding request (port
of ``repro/spec/propose.py``, a copy: host-only).

Mirrors ``core/codecs.py``'s registry pattern: proposer *classes*
register under a name (they are stateful per engine, unlike codec
instances), ``EngineCore`` instantiates one via ``make_proposer`` and
drives it host-side — ``propose()`` runs between scheduling and the
device dispatch, so proposers must be cheap. Wrong guesses cost only
wasted verify work, never correctness: the verifier accepts exactly the
tokens the target model would have produced (spec/verify.py).

This module touches no device; spec/verify.py and spec/draft.py do.
"""
from __future__ import annotations

from typing import Dict, List, Type

from repro_torch.spec.config import SpecConfig


class DraftProposer:
    """Base/protocol for draft proposers.

    Lifecycle: constructed once per engine, ``reset()`` at each serving
    session, ``propose(req, k)`` per decode-ready request per step,
    ``release(rid)`` when a request leaves its slot (finish, cancel, or
    preempt — after a preempt the context may *shrink*, so per-request
    state must not assume monotone growth).
    """

    name: str = ""

    def __init__(self, spec: SpecConfig, *, target_cfg=None,
                 target_model=None, target_params=None,
                 max_len: int = 0) -> None:
        self.spec = spec
        self.target_cfg = target_cfg

    def reset(self) -> None:
        """Drop all per-request state (new serving session)."""

    def release(self, rid: str) -> None:
        """A request left the engine; forget its state."""

    def propose(self, req, k: int) -> List[int]:
        """Up to ``k`` draft tokens continuing ``req``'s context
        (``req.prompt`` + ``req.out_tokens``). Fewer — or none — is
        always legal."""
        raise NotImplementedError

    def feedback(self, rid, drafted: int, accepted: int) -> None:
        """Verification outcome for the last proposal (optional hook):
        ``accepted`` of ``drafted`` tokens survived. Proposers may adapt
        — draft quality only, never correctness."""


_PROPOSERS: Dict[str, Type[DraftProposer]] = {}


def register_proposer(cls: Type[DraftProposer], *,
                      overwrite: bool = False) -> Type[DraftProposer]:
    """Register a proposer class under ``cls.name`` (usable as a
    decorator, like ``register_codec``)."""
    if not cls.name:
        raise ValueError(f"{cls.__name__} needs a non-empty .name")
    if cls.name in _PROPOSERS and not overwrite:
        raise ValueError(f"proposer {cls.name!r} already registered "
                         "(pass overwrite=True to replace)")
    _PROPOSERS[cls.name] = cls
    return cls


def get_proposer(name: str) -> Type[DraftProposer]:
    try:
        return _PROPOSERS[name]
    except KeyError:
        raise KeyError(f"unknown proposer {name!r}; registered: "
                       f"{sorted(_PROPOSERS)}") from None


def list_proposers() -> List[str]:
    return sorted(_PROPOSERS)


def make_proposer(spec: SpecConfig, **kwargs) -> DraftProposer:
    """Instantiate the proposer named by ``spec.mode``."""
    return get_proposer(spec.mode)(spec, **kwargs)


@register_proposer
class NgramProposer(DraftProposer):
    """Self-speculative prompt lookup: no extra model, no device work.

    Match the last n context tokens (n = max_ngram down to min_ngram)
    against earlier positions in the request's own prompt + output; on a
    hit, propose the k tokens that followed the *most recent* earlier
    occurrence (repetition is local — code, quoting, chat boilerplate).
    Misses cost nothing: an empty proposal makes the step plain decode.

    Verification feedback drives an exponential backoff: a streak of
    fully-rejected proposals (the context repeats but the model isn't
    following the repetition) pauses drafting for ``2^streak`` steps, so
    a non-cooperating request quickly degrades to ~vanilla step cost
    instead of paying the verify premium every step. Any accepted draft
    resets the streak.

    Feedback also ramps the draft *length*: verify cost grows ~linearly
    with span width, so wide spans only pay off when acceptance is high.
    Each request starts at 2 drafts; a fully-accepted proposal doubles
    its cap (up to ``spec.k``), a partial acceptance holds it near what
    was accepted, and a full rejection resets it — a request locked into
    repetition quickly earns full-width spans while a chaotic one never
    pays for more than narrow probes.
    """

    name = "ngram"
    _max_backoff = 32
    _start_cap = 2

    def __init__(self, spec: SpecConfig, **kwargs) -> None:
        super().__init__(spec, **kwargs)
        self._cooldown: Dict[int, List[int]] = {}  # rid -> [skip, streak]
        # rid -> incremental match state: the context as a plain int list
        # plus, per ngram size n, a dict mapping the n-gram tuple to its
        # two most recent start positions (latest, previous). propose()
        # is then O(max_ngram) dict lookups instead of an O(n * len)
        # rescan of the whole context every step — the proposer bills to
        # the session clock, so it must stay microseconds-cheap.
        self._state: Dict[int, dict] = {}
        self._cap: Dict[int, int] = {}   # rid -> current draft-length cap

    def reset(self) -> None:
        self._cooldown.clear()
        self._state.clear()
        self._cap.clear()

    def release(self, rid) -> None:
        # after preempt the context shrinks; drop and lazily rebuild
        self._cooldown.pop(rid, None)
        self._state.pop(rid, None)
        self._cap.pop(rid, None)

    def feedback(self, rid, drafted: int, accepted: int) -> None:
        if drafted <= 0:
            return
        cap = self._cap.get(rid, self._start_cap)
        if accepted >= drafted:
            cap = min(cap * 2, self.spec.k)
        elif accepted > 0:
            cap = max(self._start_cap, accepted + 1)
        else:
            cap = self._start_cap
        self._cap[rid] = cap
        cd = self._cooldown.setdefault(rid, [0, 0])
        if accepted > 0:
            cd[0] = cd[1] = 0
        else:
            cd[1] += 1
            cd[0] = min(2 ** cd[1], self._max_backoff)

    def _sync(self, req) -> dict:
        """Fold tokens appended since the last call into the index."""
        st = self._state.get(req.rid)
        if st is None:
            st = self._state[req.rid] = {
                "ctx": [int(t) for t in req.prompt],
                "idx": {n: {} for n in range(self.spec.min_ngram,
                                             self.spec.max_ngram + 1)},
                "done": 0,   # indexed prefix length
            }
        ctx = st["ctx"]
        ctx.extend(int(t) for t in req.out_tokens[st.pop("_out", 0):])
        st["_out"] = len(req.out_tokens)
        idx, done = st["idx"], st["done"]
        for p in range(done, len(ctx)):
            for n, table in idx.items():
                if p + 1 >= n:
                    key = tuple(ctx[p + 1 - n:p + 1])
                    prev = table.get(key)
                    table[key] = (p + 1 - n,
                                  prev[0] if prev is not None else None)
        st["done"] = len(ctx)
        return st

    def propose(self, req, k: int) -> List[int]:
        k = min(k, self._cap.get(req.rid, self._start_cap))
        if k <= 0:
            return []
        cd = self._cooldown.get(req.rid)
        if cd is not None and cd[0] > 0:
            cd[0] -= 1
            return []
        st = self._sync(req)
        ctx = st["ctx"]
        for n in range(self.spec.max_ngram, self.spec.min_ngram - 1, -1):
            if len(ctx) <= n:
                continue
            hit = st["idx"][n].get(tuple(ctx[-n:]))
            if hit is None:
                continue
            # the latest occurrence is the suffix itself (indexed when
            # its final token arrived); the previous one is the most
            # recent *earlier* match the old linear scan would find
            i = hit[1] if hit[0] == len(ctx) - n else hit[0]
            if i is not None:
                return ctx[i + n:i + n + k]
        return []
