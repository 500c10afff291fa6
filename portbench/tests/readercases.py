"""The per-layer readers' cases (``metrics/cases/<metric>.py``): the
synthetic traces and layers they build on, and the check that runs one.

A case module gives ``layer()``, a synthetic layer as a job would hand it
to the readers, ``EXPECTED``, the value that the metric's reader has to
read from it, worked out by hand, and ``empty()``, a layer with nothing
for the reader, on which it has to return None."""
from __future__ import annotations

import os
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

import tiny
from portbench import harness, trace


def ev(name, start, end, device=False, eid=0, annotation=False):
    """A profiler event: a host range or runtime call, or a device item."""
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU, id=eid,
                           is_user_annotation=annotation)


def events():
    """A 1000 us window: two steps' ranges, launches and device items."""
    return [
        ev(trace.WINDOW, 0, 1000),
        ev("chain.net_forward", 0, 100), ev("chain.objective_forward", 100, 400),
        ev("chain.objective_backward", 400, 500), ev("chain.net_backward", 500, 600),
        ev("chain.ng", 600, 650), ev("chain.optimizer", 650, 700),
        ev("portbench.load", 700, 1000),
        ev("cudaLaunchKernel", 10, 12, eid=1), ev("gemm_kernel", 20, 90, True, 1),
        ev("cudaLaunchKernel", 110, 112, eid=2), ev("void den_fwd<4, true>", 120, 170, True, 2),
        ev("cudaLaunchKernel", 410, 412, eid=3), ev("void den_bwd<4, true>", 420, 470, True, 3),
        ev("cudaLaunchKernel", 510, 512, eid=4), ev("shc_band_kernel<4, 21>", 515, 535, True, 4),
        ev("cudaLaunchKernel", 520, 522, eid=5), ev("gemm_kernel", 530, 580, True, 5),
        ev("chain.net_forward", 0, 0, True, 9, annotation=True),
    ]


def span(name, stream_ms):
    """A span as the program's recorder keeps it (``stream_ms`` None
    without its events)."""
    return SimpleNamespace(name=name, stream_ms=stream_ms)


def layer(**changes):
    """The layer of ``events()``: the benchmark's spans, two timed steps,
    and the bounds, rates and audio the readers divide by; busy 235 us of
    the trace for 1 ms of audio, at 2 audio-s/s untraced."""
    spans = SimpleNamespace(device_ms={"get_f0": [2.0, 4.0], "convert": [5.0]},
                            host={"load": [1.0, 3.0], "chain.net_forward": [0.1, 0.05],
                                  "chain.net_backward": [0.05], "chain.objective_forward": [0.3],
                                  "chain.objective_backward": [0.1], "chain.ng": [0.06],
                                  "chain.optimizer": [0.04]})
    out = {"digest": trace.digest(events()), "spans": spans, "phase_steps": 2,
           "k1_bound_s": 10e-6, "den_bound_s": 25e-6, "mfu": 0.125,
           "traced_audio_s": 1e-3, "audio_s_per_s": 2.0}
    out.update(changes)
    return out


def empty():
    """A layer in which no reader finds anything: an empty trace, no
    recorded spans, no operations counted."""
    return {"digest": trace.digest([]), "phase_steps": 1, "profiled_steps": 1,
            "k1_bound_s": 1e-6, "den_bound_s": 1e-6, "num_bound_s": 1e-6, "mfu": None,
            "traced_audio_s": 0.0, "audio_s_per_s": 2.0, "recorded": None,
            "spans": SimpleNamespace(device_ms={}, host={})}


def check(name: str, root: str = tiny.ROOT) -> None:
    """Run the case of the metric ``name`` under ``root``: its reader reads
    the case's ``EXPECTED`` from its ``layer()`` and None from its
    ``empty()``. A metric without a case fails, by name."""
    home = os.path.join(root, "portbench", "metrics")
    path = os.path.join(home, "cases", name + ".py")
    if not os.path.exists(path):
        pytest.fail(f"the per-layer metric {name!r} has no case: add "
                    f"portbench/metrics/cases/{name}.py")
    case = harness.load_module(path, "portbench_case_" + name.replace(".", "_"))
    reader = harness.load_module(os.path.join(home, name + ".py"),
                                 "portbench_metric_" + name.replace(".", "_"))
    assert reader.read(case.layer()) == pytest.approx(case.EXPECTED), name
    assert reader.read(case.empty()) is None, name
