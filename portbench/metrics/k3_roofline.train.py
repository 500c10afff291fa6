"""The numerator kernels' (K3f + K3b) share of their roofline over the
traced steps: the least time their calls could take, counted from each
step's frames and its graphs' states, live arcs and pdfs on those arcs
(``counts.k3_bound_s``), over the device time of ``num_fwd`` and
``num_bwd`` in the trace, in %. The zero fill of the posteriors is a
kernel of its own: neither its bytes nor its time count."""
from portbench.trace import kernel_us


def read(layer):
    us = kernel_us(layer["digest"], "num_fwd", "num_bwd")
    return 100.0 * layer["num_bound_s"] / (us / 1e6) if us > 0 else None
