"""K1's share of its roofline over the traced pass: the least time its
calls could take, counted from the batches' shapes
(``counts.k1_bound_s``), over the device time of the SHC kernel
(``shc_band_kernel``) in the trace, in %."""
from portbench.trace import kernel_us


def read(layer):
    us = kernel_us(layer["digest"], "shc_band_kernel")
    return 100.0 * layer["k1_bound_s"] / (us / 1e6) if us > 0 else None
