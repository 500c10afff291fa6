"""Stream milliseconds per batch of YAAPT's two Viterbi DPs: the program's
``yaapt.dynamic5`` and ``yaapt.dynamic_final`` spans, each a CUDA event
pair, over the corpus pass served with the recorder on
(``trace.span_ms``)."""
from portbench.trace import span_ms


def read(layer):
    return span_ms(layer, ("yaapt.dynamic5", "yaapt.dynamic_final"))
