"""Milliseconds per step of the network's forward and backward: the trainer's
``chain.net_forward`` and ``chain.net_backward`` ranges, timed on the host
clock with the card synchronised at each edge, over the untraced steps
that time them (``trace.timed_ranges``, no profiler running)."""
from portbench.trace import phase_ms


def read(layer):
    return phase_ms(layer, ("chain.net_forward", "chain.net_backward"))
