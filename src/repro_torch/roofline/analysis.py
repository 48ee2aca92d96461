"""Roofline terms of a counted step, the port of the JAX package's
``roofline/analysis.py``.

    compute    = FLOPs / (chips * peak FLOP/s of the step's dtype)
    memory     = bytes / (chips * HBM bandwidth)
    collective = collective bytes / (chips * link bandwidth)

JAX walks the post-optimization HLO text of a compiled step. The port
compiles nothing: its counts come from running the step itself under a
:class:`~.count.CostTally` (on ``meta`` tensors for the dry run), which
sees every aten op dispatched, the kernel entries reported by the kernel
wrappers, and the collectives' byte tally. :func:`roofline_terms` and
:func:`top_contributors` take that tally where JAX's take HLO text, and
give the same results: ``(terms, cost)``, and ``(value, kind, line)``
tuples in modes ``bytes`` / ``flops`` / ``coll``. The tally counts the
whole mesh (one controller runs every position), where JAX's walker
counts one device's program: ``cost`` is per chip, the terms' totals are
the tally's.

HLO parsing has no counterpart here: ``parse_computations``, ``callees``,
``trip_count``, ``call_multipliers`` and ``analyze_hlo`` are not ported.
Eager PyTorch runs every op as written, so the tally needs no trip counts
(a loop's body runs, and counts, once per trip) and no fusion rule (every
op's output is stored).
"""

from __future__ import annotations

import dataclasses

from . import hw
from .count import CostTally

__all__ = [
    "HloCost",
    "RooflineTerms",
    "roofline_terms",
    "static_memory_seconds",
    "static_roofline_terms",
    "top_contributors",
]


@dataclasses.dataclass
class HloCost:
    """Per-chip counts, JAX's ``HloCost`` fields: the tally's totals over
    the chips; ``collectives`` is ``{kind: {"count", "bytes"}}`` with each
    call counted once (as one SPMD program issues it) and its bytes per
    chip."""

    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    flops: float  # total FLOPs (all devices)
    hbm_bytes: float  # total bytes accessed
    collective_bytes: float  # total collective payload bytes
    chips: int
    # FLOP/s of one chip for the step's compute dtype (hw.peak_flops); JAX's
    # terms always take the bf16 peak.
    peak_flops: float = hw.PEAK_FLOPS_BF16

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * self.peak_flops)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * hw.HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / (self.chips * hw.ICI_BW_PER_LINK)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline-optimistic step time (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
        }


def roofline_terms(tally: CostTally, chips: int, peak_flops: float = hw.PEAK_FLOPS_BF16
                   ) -> tuple[RooflineTerms, HloCost]:
    """Terms from a counted step over ``chips`` positions: the totals are
    the tally's (every position's work), the per-chip ``cost`` divides them
    out. ``peak_flops``: the chip's rate for the step's compute dtype
    (:func:`~.hw.peak_flops`)."""
    coll = tally.collectives
    terms = RooflineTerms(
        flops=float(tally.flops),
        hbm_bytes=float(tally.bytes),
        collective_bytes=tally.collective_bytes,
        chips=chips,
        peak_flops=peak_flops,
    )
    cost = HloCost(
        flops=terms.flops / chips,
        bytes=terms.hbm_bytes / chips,
        collective_bytes=terms.collective_bytes / chips,
        collectives={k: {"count": v["count"], "bytes": v["bytes"] / chips}
                     for k, v in coll.items()},
    )
    return terms, cost


def static_memory_seconds(required_bytes: float, chips: int = 1) -> float:
    """Attainable-bandwidth floor on step time from statically required
    bytes."""
    return required_bytes / (chips * hw.HBM_BW)


def static_roofline_terms(required_bytes: float, chips: int = 1) -> RooflineTerms:
    """A memory-only :class:`RooflineTerms` from static required bytes
    (FLOPs/collectives unknown before anything runs → zero)."""
    return RooflineTerms(
        flops=0.0,
        hbm_bytes=float(required_bytes),
        collective_bytes=0.0,
        chips=chips,
    )


def top_contributors(
    tally: CostTally, mode: str = "bytes", limit: int | None = None
) -> list[tuple[float, str, str]]:
    """Per-op contributors of a counted step, largest first.

    ``mode``: ``"bytes"`` (every op's bytes), ``"flops"`` (the FLOPs of
    matmuls, convolutions, elementwise ops and kernel entries) or
    ``"coll"`` (collective bytes by kind). Returns ``(value, op_kind,
    line)`` tuples: ``op_kind`` the aten op (``aten.mm.default``) or kernel
    entry (``kernel:flash_attention``) or collective kind, ``line`` the op
    with its input shapes and how many times it ran.
    """
    if mode not in ("bytes", "flops", "coll"):
        raise ValueError(f"unknown mode {mode!r} (expected bytes|flops|coll)")
    contrib: list[tuple[float, str, str]] = []
    if mode == "coll":
        for kind, v in tally.collectives.items():
            if v["bytes"] > 0:
                contrib.append((float(v["bytes"]), kind, f"{kind} x{v['count']}"))
    else:
        col = 2 if mode == "bytes" else 1
        for (op, shapes), row in tally.ops.items():
            if row[col] > 0:
                shape_text = ", ".join(str(list(s)) for s in shapes)
                contrib.append((row[col], op, f"{op}({shape_text}) x{row[0]}"))
    contrib.sort(key=lambda t: -t[0])
    return contrib[:limit] if limit is not None else contrib
