"""Host milliseconds per step of ``EgsDataset.load_batch`` and the copy of
the batch to the card: the benchmark's own span, over the untraced steps
whose trainer ranges are timed."""
from statistics import fmean


def read(layer):
    ms = layer["spans"].host.get("load")
    return fmean(ms) if ms else None
