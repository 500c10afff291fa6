"""Milliseconds per step of the chain objective, numerator and den,
forward and backward: the trainer's
``chain.objective_forward`` and ``chain.objective_backward`` ranges, timed on the host
clock with the card synchronised at each edge, over the untraced steps
that time them (``trace.timed_ranges``, no profiler running)."""
from portbench.trace import phase_ms


def read(layer):
    return phase_ms(layer, ("chain.objective_forward", "chain.objective_backward"))
