"""A 100 us pass of two batches: ``portbench.get_f0`` 0-80 holds
``yaapt.nlfer`` 10-30, ``yaapt.dynamic5`` 40-60 and ``yaapt.dynamic_final``
60-80; one kernel is launched in nlfer, two in dynamic5 and one in
dynamic_final, so the DPs launch 3 / 2 a batch."""
import readercases as rc
from portbench import trace
from readercases import empty  # noqa: F401

EXPECTED = 1.5


def layer():
    evs = [rc.ev(trace.WINDOW, 0, 100), rc.ev("portbench.get_f0", 0, 80),
           rc.ev("yaapt.nlfer", 10, 30), rc.ev("yaapt.dynamic5", 40, 60),
           rc.ev("yaapt.dynamic_final", 60, 80),
           rc.ev("cudaLaunchKernel", 11, 12, eid=1), rc.ev("fft", 12, 20, True, 1),
           rc.ev("cudaLaunchKernel", 41, 42, eid=2), rc.ev("add", 45, 50, True, 2),
           rc.ev("cudaLaunchKernel", 51, 52, eid=3), rc.ev("min", 52, 54, True, 3),
           rc.ev("cudaLaunchKernel", 65, 66, eid=4), rc.ev("argmin", 66, 70, True, 4)]
    return rc.layer(digest=trace.digest(evs, ("portbench.", "yaapt.")), profiled_steps=2)
