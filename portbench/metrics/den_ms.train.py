"""Stream milliseconds per step of the chain denominator: the program's
``chain.den_forward`` (K2f) and ``chain.den_backward`` (K2b, on the
autograd engine's thread) spans, each a CUDA event pair, over the steps
taken with the recorder on (``trace.span_ms``)."""
from portbench.trace import span_ms


def read(layer):
    return span_ms(layer, ("chain.den_forward", "chain.den_backward"))
