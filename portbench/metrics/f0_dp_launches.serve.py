"""Device items launched per batch inside YAAPT's two Viterbi DPs: the
kernels whose launch falls inside the program's ``yaapt.dynamic5`` or
``yaapt.dynamic_final`` range (the innermost named range open) in the
profiled pass over the corpus (``trace.launches_inside``)."""
from portbench.trace import launches_inside


def read(layer):
    return launches_inside(layer, ("yaapt.dynamic5", "yaapt.dynamic_final"))
