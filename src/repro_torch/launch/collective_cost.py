"""Collective traffic of a step, per device, from the port's own tally.

PyTorch counterpart of ``repro/launch/hlo_cost.py``.  The reference parses
the optimized HLO of a compiled step, finds every collective and multiplies
those inside a ``while`` body by the loop's trip count.  Here there is no
HLO to parse and no trip count to find: inside
``distribution/collectives.tally()`` every collective the port calls adds
one (kind, output bytes, group size) entry as it runs, a Python loop's
iterations each adding their own.  :func:`collective_wire_bytes` prices
the entries with the reference's ring-algorithm factors (``_wire_bytes``):

    all-reduce          2·b·(g-1)/g    (reduce-scatter + all-gather phases)
    all-gather          out·(g-1)/g    (each device receives all but its own)
    reduce-scatter      out·(g-1)      (= in·(g-1)/g)
    all-to-all          b·(g-1)/g
    collective-permute  b

and the two kinds only the port calls: ``broadcast`` b·(g-1)/g (every
rank but the root receives b) and ``barrier`` 0.  g is the group size.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple


def wire_bytes(kind: str, out_bytes: float, g: int) -> float:
    """Bytes one device moves for one collective of ``kind`` with
    ``out_bytes`` of output over a group of ``g``."""
    if g <= 1 or kind == "barrier":
        return 0.0
    if kind == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / g
    if kind in ("all-gather", "all-to-all", "broadcast"):
        return out_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return float(out_bytes) * (g - 1)
    if kind == "collective-permute":
        return float(out_bytes)
    raise ValueError(f"unknown collective kind {kind!r}")


def collective_wire_bytes(calls: Iterable[Tuple[str, int, int]]
                          ) -> Dict[str, float]:
    """Per-device wire bytes by collective kind, and their ``total``, of a
    tally's (kind, output bytes, group size) entries."""
    out: Dict[str, float] = {}
    for kind, nbytes, g in calls:
        out[kind] = out.get(kind, 0.0) + wire_bytes(kind, nbytes, g)
    out["total"] = sum(out.values())
    return out


def summarize(calls: Iterable[Tuple[str, int, int]]) -> Dict[str, dict]:
    """{kind: {"calls": n, "bytes": output bytes summed}}: the tally as a
    dry run's record and the tests compare it."""
    out: Dict[str, dict] = {}
    for kind, nbytes, _ in calls:
        e = out.setdefault(kind, {"calls": 0, "bytes": 0})
        e["calls"] += 1
        e["bytes"] += nbytes
    return out
