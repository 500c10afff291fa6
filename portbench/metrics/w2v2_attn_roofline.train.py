"""The fused attention's share of its roofline over the profiled steps: the
least time of every layer's attention forward and backward, counted from
each step's batch and the front's frames (``counts_w2v2.attention_bound_s``,
at a third of the TF32 peak, the fastest an attention accurate to float32
can run), over the device time of the attention kernels in the trace
(PyTorch's memory-efficient ``fmha_cutlass`` kernels in float32, flash
attention's under the bf16 policy), in %. Under bf16 the peak is not the
kernels' own and the share is not comparable."""
from portbench.trace import kernel_us

KERNELS = ("fmha_cutlass", "flash_fwd", "flash_bwd")


def read(layer):
    us = kernel_us(layer["digest"], *KERNELS)
    return 100.0 * layer["attn_bound_s"] / (us / 1e6) if us > 0 else None
