"""Stream milliseconds from the start to the end of ``convert`` (the
extractor and the generator) per batch: the benchmark's CUDA events around
the call, over the untraced batches."""
from statistics import fmean


def read(layer):
    ms = layer["spans"].device_ms.get("convert")
    return fmean(ms) if ms else None
