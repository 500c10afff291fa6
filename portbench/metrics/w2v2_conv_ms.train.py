"""Stream milliseconds per step of the wav2vec2 front's conv extractor and
projection: the program's ``wav2vec2.conv`` span, a CUDA event pair, over the
steps taken with the recorder on (``trace.span_ms``)."""
from portbench.trace import span_ms


def read(layer):
    return span_ms(layer, ("wav2vec2.conv",))
