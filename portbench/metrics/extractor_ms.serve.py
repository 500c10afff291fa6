"""Stream milliseconds per batch of the BN extractor (fbank, CMVN, TDNN-F
and VQ): the program's ``anon.extractor`` span, a CUDA event pair, over
the corpus pass served with the recorder on (``trace.span_ms``)."""
from portbench.trace import span_ms


def read(layer):
    return span_ms(layer, ("anon.extractor",))
