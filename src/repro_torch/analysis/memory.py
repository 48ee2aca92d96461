"""Byte accounting of a traced step, the port's ``memory_report``.

JAX reads ``compiled.memory_analysis()`` of a compiled step. The port
compiles nothing: it runs the step under a
:class:`~repro_torch.roofline.count.CostTally`, which registers the step's
arguments per mesh position and follows every storage that the step
creates, on the position it belongs to, until it is freed. The keys are
JAX's:

* ``argument_bytes``: the arguments a position holds (params, optimizer
  moments, batch, caches);
* ``output_bytes``: the step's outputs that are not arguments;
* ``temp_bytes``: the peak of live bytes during the step above the
  arguments;
* ``alias_bytes``: arguments the step wrote in place (caches; in a train
  step also the params and moments, which the port's AdamW updates in
  place where JAX's undonated step writes new buffers);
* ``generated_code_bytes``: ``None``, nothing is compiled.

Each is the maximum over positions, as one device's figure; ``per_position``
holds every position's, in position order. Which position a byte belongs
to follows the tally's rules (an op's largest input's position, a
gradient's at its forward op's position, a collective's output at the
position receiving it); ``peak_bytes_all_positions``, the peak of every
position's live bytes together (what one card holding every position
holds at most), does not depend on them. ``shared_argument_bytes`` is
the part of position 0's arguments that it holds for every position (a
global batch, the step counters).
"""

from __future__ import annotations

from ..roofline.count import CostTally

__all__ = ["memory_report"]

KEYS = ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes")


def memory_report(tally: CostTally, outputs=None) -> dict:
    """JAX's ``memory_analysis`` keys from a traced step: ``tally`` the
    step's :class:`~repro_torch.roofline.count.CostTally` (its arguments
    registered), ``outputs`` the tree the step returned."""
    per = {
        "argument_bytes": list(tally.args),
        "output_bytes": tally.new_bytes(outputs if outputs is not None else []),
        "temp_bytes": tally.temp(),
        "alias_bytes": tally.written_arguments(),
    }
    return {**{k: max(per[k]) for k in KEYS}, "generated_code_bytes": None,
            "peak_bytes_all_positions": tally.total_peak,
            "shared_argument_bytes": tally.shared_args, "per_position": per}
