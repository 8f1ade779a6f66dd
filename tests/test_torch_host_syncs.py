"""Host synchronisations of the port's serve stack: every one is in
``serve/core.py`` and says why (the counterpart of
``scripts/check_host_syncs.sh`` for the JAX package).

In ``src/repro_torch/serve``, each ``.cpu()``, ``.item()``, ``.tolist()``,
``.numpy()`` and ``.synchronize(`` (of the device, a stream or an event)
must carry a trailing ``# sync: <reason>`` and sit in ``core.py``: a sync
anywhere else, or an unexplained one, is a stall of the decode pipeline
nobody decided on.

A sync the pattern cannot see: a ``non_blocking`` copy between the card
and *pageable* host memory (``torch.from_numpy``, a plain CPU tensor) may
wait for the stream. Host inputs of a decode dispatch are staged in
pinned memory (``pin_memory()``, ``serve/graphs.py``) and a token block
comes back into a pinned tensor whose copy an event marks
(``EngineCore._fetch_async``)."""
import re
from pathlib import Path

import pytest

SERVE = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "serve"
SYNC = re.compile(r"\.(cpu|item|tolist|numpy)\(\)|\.synchronize\(")
MARK = re.compile(r"#\s*sync:\s*\S")


def sync_faults(name: str, text: str) -> list[str]:
    """Lines of file ``name`` holding a host sync that is unmarked or lies
    outside ``core.py``."""
    faults = []
    for i, line in enumerate(text.splitlines(), 1):
        code = line.split("#", 1)[0]
        if not SYNC.search(code):
            continue
        if name != "core.py":
            faults.append(f"{name}:{i}: host sync outside core.py")
        elif not MARK.search(line):
            faults.append(f"{name}:{i}: host sync without '# sync: <reason>'")
    return faults


def test_serve_syncs_are_marked_and_in_core():
    files = sorted(SERVE.glob("*.py"))
    assert {"core.py", "graphs.py", "api.py"} <= {f.name for f in files}
    faults = [f for p in files for f in sync_faults(p.name, p.read_text())]
    assert not faults, "\n".join(faults)
    marked = sum(bool(SYNC.search(ln.split("#", 1)[0]))
                 for ln in (SERVE / "core.py").read_text().splitlines())
    assert marked >= 4   # prefill, chunk, one-token step, horizon landing


@pytest.mark.parametrize("name,line,bad", [
    ("core.py", "toks = nxt.cpu().numpy()", True),
    ("core.py", "toks = nxt.cpu().numpy()  # sync: token fetch", False),
    ("core.py", "torch.cuda.synchronize(dev)  # sync:", True),
    ("core.py", "blk['ready'].synchronize()", True),
    ("core.py", "blk['ready'].synchronize()  # sync: block lands", False),
    ("graphs.py", "self.stream.synchronize()  # sync: why", True),
    ("graphs.py", "n = int(x.item())  # sync: count", True),
    ("api.py", "x = t.tolist()", True),
    ("api.py", "# t.tolist() in a comment", False),
    ("engine.py", "x = torch.from_numpy(a)", False),
])
def test_sync_checker_flags_faults(name, line, bad):
    assert bool(sync_faults(name, line)) == bad
