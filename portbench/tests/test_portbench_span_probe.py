"""The span probe's readings (``portbench/span_probe.py``) on synthetic spans
and events, each against a value computed by hand: the F0 DPs, extractor,
generator, numerator (with the objective backward's self time) and den a
step, the digest's idle time put down to a program span nested inside a
benchmark range, and the launches inside the DPs."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

import tiny  # noqa: F401  puts the checkout on the path
from portbench import span_probe, trace


def span(name, step, stream_ms, sid=0, parent=None):
    return SimpleNamespace(name=name, step=step, stream_ms=stream_ms, id=sid, parent=parent)


def ev(name, start, end, device=False, eid=0):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                           device_type=DeviceType.CUDA if device else DeviceType.CPU, id=eid,
                           is_user_annotation=False)


def test_serving_readings_a_batch():
    spans = [span("yaapt.dynamic5", 0, 10.0), span("yaapt.dynamic_final", 0, 5.0),
             span("yaapt.dynamic5", 1, 12.0), span("yaapt.dynamic_final", 1, 3.0),
             span("yaapt.nlfer", 0, 50.0), span("anon.extractor", 0, 8.0),
             span("anon.extractor", 1, 10.0), span("anon.generator", 0, 80.0),
             span("anon.generator", 1, 90.0), span("anon.generator", 1, None)]
    assert span_probe.per_step(spans, span_probe.F0_DP, 2) == pytest.approx(15.0)
    assert span_probe.per_step(spans, ("anon.extractor",), 2) == pytest.approx(9.0)
    assert span_probe.per_step(spans, ("anon.generator",), 2) == pytest.approx(85.0)


def test_numerator_takes_the_objective_backwards_self_time():
    """Numerator a step: its forward and the xent posteriors, plus the
    objective backward less the den backward inside it; den: its forward
    and backward."""
    spans = [span("chain.num_forward", 0, 100.0), span("chain.xent_posteriors", 0, 90.0),
             span("chain.den_forward", 0, 4.0), span("chain.objective_backward", 0, 120.0),
             span("chain.den_backward", 0, 6.0),
             span("chain.num_forward", 1, 110.0), span("chain.xent_posteriors", 1, 80.0),
             span("chain.den_forward", 1, 5.0), span("chain.objective_backward", 1, 130.0),
             span("chain.den_backward", 1, 7.0)]
    obj = span_probe.by_step(spans, ("chain.objective_backward",))
    den = span_probe.by_step(spans, ("chain.den_backward",))
    self_bwd = sum(v - den.get(k, 0.0) for k, v in obj.items())
    numerator = span_probe.per_step(spans, span_probe.NUMERATOR, 2) + self_bwd / 2
    # (100 + 90 + 114 + 110 + 80 + 123) / 2
    assert numerator == pytest.approx(308.5)
    assert span_probe.per_step(spans, span_probe.DEN, 2) == pytest.approx(11.0)


def test_idle_inside_a_program_span_nested_in_a_benchmark_range():
    """A 100 us window: ``portbench.get_f0`` 0-80 holds ``yaapt.nlfer``
    10-30 and ``yaapt.dynamic_final`` 40-80; the card is busy 12-20 (launched
    in nlfer) and 45-50 and 60-62 (launched in dynamic_final)."""
    from satpu_torch.utils import trace as program_trace

    events = [ev(trace.WINDOW, 0, 100), ev("portbench.get_f0", 0, 80),
              ev("yaapt.nlfer", 10, 30), ev("yaapt.dynamic_final", 40, 80),
              ev("cudaLaunchKernel", 11, 12, eid=1), ev("fft", 12, 20, True, 1),
              ev("cudaLaunchKernel", 41, 42, eid=2), ev("add", 45, 50, True, 2),
              ev("cudaLaunchKernel", 55, 56, eid=3), ev("min", 60, 62, True, 3)]
    pre = span_probe.prefixes(program_trace)
    assert "portbench." in pre and "yaapt." in pre and "chain." in pre
    d = trace.digest(events, pre)
    gaps = d["idle_by_range"]
    # idle: 0-10 and 30-40 under get_f0 alone, 10-12 and 20-30 in nlfer,
    # 40-45, 50-60, 62-80 in dynamic_final, 80-100 in none
    assert gaps["portbench.get_f0"] == 20
    assert gaps["yaapt.nlfer"] == 12
    assert gaps["yaapt.dynamic_final"] == 33
    assert gaps["(no range)"] == 20
    assert span_probe.launches_inside(d, span_probe.F0_DP, 1) == 2
    named, idle = span_probe.idle_named(d, ("yaapt.",))
    assert (named, idle) == (45e-6, 85e-6)
    # the benchmark's own prefixes see none of it
    assert "yaapt.dynamic_final" not in trace.digest(events)["idle_by_range"]
