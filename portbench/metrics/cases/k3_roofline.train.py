"""K3's bound of 8 us over 100 us of ``num_fwd`` and 300 us of ``num_bwd``
in a 1000 us trace that also holds the den kernels: 2%."""
import readercases as rc
from portbench import trace
from readercases import empty  # noqa: F401

EXPECTED = 2.0


def layer():
    evs = [rc.ev(trace.WINDOW, 0, 1000),
           rc.ev("cudaLaunchKernel", 10, 12, eid=1), rc.ev("num_fwd(FwdArgs)", 20, 120, True, 1),
           rc.ev("cudaLaunchKernel", 130, 132, eid=2), rc.ev("void den_fwd<4, true>", 140, 190,
                                                              True, 2),
           rc.ev("cudaLaunchKernel", 200, 202, eid=3), rc.ev("num_bwd(BwdArgs)", 210, 510, True, 3)]
    return rc.layer(digest=trace.digest(evs), num_bound_s=8e-6)
