"""Roofline model of the port on the NVIDIA H100: the card's constants
(:mod:`.hw`), the counted cost of a step (:mod:`.count`) and its roofline
terms (:mod:`.analysis`)."""

from . import hw
from .analysis import (
    HloCost,
    RooflineTerms,
    roofline_terms,
    static_memory_seconds,
    static_roofline_terms,
    top_contributors,
)
from .count import CostTally, report_kernel

__all__ = [
    "hw",
    "CostTally",
    "HloCost",
    "RooflineTerms",
    "report_kernel",
    "roofline_terms",
    "static_memory_seconds",
    "static_roofline_terms",
    "top_contributors",
]
