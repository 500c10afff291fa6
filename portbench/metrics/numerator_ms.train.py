"""Stream milliseconds per step of the chain numerator: the program's
``chain.num_forward`` (the arcs' grouping, K3f and K3b) and
``chain.xent_posteriors`` (the xent product) spans, each a CUDA event pair,
over the steps taken with the recorder on (``trace.span_ms``)."""
from portbench.trace import span_ms


def read(layer):
    return span_ms(layer, ("chain.num_forward", "chain.xent_posteriors"))
