"""Stream milliseconds from the start to the end of ``get_f0`` per batch:
the benchmark's CUDA events around the call, over the untraced batches."""
from statistics import fmean


def read(layer):
    ms = layer["spans"].device_ms.get("get_f0")
    return fmean(ms) if ms else None
