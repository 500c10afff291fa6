"""The den kernels' (K2f + K2b) share of their roofline over the traced
steps: the least time their calls could take, counted from each step's
batch, frames and the den graph's nonzeros (``counts.k2_bound_s``), over
the device time of ``den_fwd`` and ``den_bwd`` in the trace, in %."""
from portbench.trace import kernel_us


def read(layer):
    us = kernel_us(layer["digest"], "den_fwd", "den_bwd")
    return 100.0 * layer["den_bound_s"] / (us / 1e6) if us > 0 else None
