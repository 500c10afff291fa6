"""Milliseconds per step of natural-gradient preconditioning and the
optimizer: the trainer's
``chain.ng`` and ``chain.optimizer`` ranges, timed on the host
clock with the card synchronised at each edge, over the untraced steps
that time them (``trace.timed_ranges``, no profiler running)."""
from portbench.trace import phase_ms


def read(layer):
    return phase_ms(layer, ("chain.ng", "chain.optimizer"))
