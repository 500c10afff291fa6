"""The attention's bound of 60 us over 100 us of the memory-efficient
forward and 200 us of its backward, in a trace that also holds a GEMM and
the den kernel: 20%."""
import readercases as rc
from portbench import trace
from readercases import empty  # noqa: F401

EXPECTED = 20.0


def layer():
    evs = [rc.ev(trace.WINDOW, 0, 1000),
           rc.ev("cudaLaunchKernel", 10, 12, eid=1),
           rc.ev("fmha_cutlassF_f32_aligned_64x64_rf_sm80(PyTorchMemEffAttention::"
                 "AttentionKernel<float, cutlass::arch::Sm80, true, 64, 64, 64, true, "
                 "true>::Params)", 20, 120, True, 1),
           rc.ev("cudaLaunchKernel", 130, 132, eid=2), rc.ev("gemm_kernel", 140, 190, True, 2),
           rc.ev("cudaLaunchKernel", 200, 202, eid=3),
           rc.ev("fmha_cutlassB_f32_aligned_64x64_k64_sm80(PyTorchMemEffAttention::"
                 "AttentionBackwardKernel<cutlass::arch::Sm80, float, true, false, true, "
                 "64, 64, 64, false>::Params)", 210, 410, True, 3),
           rc.ev("cudaLaunchKernel", 420, 422, eid=4), rc.ev("void den_fwd<4, true>", 430, 480,
                                                              True, 4)]
    return rc.layer(digest=trace.digest(evs), attn_bound_s=60e-6)
