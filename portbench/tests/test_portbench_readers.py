"""The trace digest and every per-layer reader on synthetic event lists and
layers (each reader's case is ``metrics/cases/<metric>.py``)."""
from types import SimpleNamespace

import pytest

import readercases
import tiny
from portbench import trace
from readercases import ev, events


def test_digest_by_hand():
    d = trace.digest(events())
    assert d["window_us"] == 1000
    # busy: 20-90, 120-170, 420-470, 515-580
    assert d["busy_us"] == 70 + 50 + 50 + 65
    assert d["by_op"]["gemm_kernel"] == 120
    gaps = d["idle_by_range"]
    assert gaps["chain.net_forward"] == 20 + 10
    assert gaps["chain.objective_forward"] == 20 + 230
    assert gaps["chain.objective_backward"] == 20 + 30
    assert gaps["chain.net_backward"] == 15 + 20
    assert gaps["chain.ng"] == gaps["chain.optimizer"] == 50
    assert gaps["portbench.load"] == 300
    assert sum(gaps.values()) == 1000 - d["busy_us"]
    assert sum(b - a for a, b, n in d["ranges"] if n == "chain.objective_forward") == 300
    assert trace.kernel_us(d, "den_fwd", "den_bwd") == 100
    assert [n for n, _ in d["inside"]["chain.net_backward"]] == ["shc_band_kernel<4, 21>",
                                                                  "gemm_kernel"]
    b = trace.breakdown(d)
    assert b["device_ops"][0] == ["gemm_kernel", 120e-6]
    assert b["idle_gaps"][0] == ["portbench.load", 300e-6]


METRICS = sorted(m["name"] for m in tiny.bench()["per_layer"])


@pytest.mark.parametrize("name", METRICS)
def test_reader_case(name):
    """Each declared metric's reader against its case
    (``metrics/cases/<metric>.py``): the value worked out by hand, and None
    where it finds nothing."""
    readercases.check(name)


def program_events():
    """``events()`` with the program's ranges nested in the benchmark's:
    YAAPT's stages inside ``portbench.get_f0``, the den's forward inside
    ``chain.objective_forward``."""
    return events() + [ev("portbench.get_f0", 500, 600), ev("yaapt.nlfer", 501, 505),
                       ev("yaapt.dynamic5", 505, 600), ev("chain.den_forward", 105, 300)]


def test_program_prefixes_name_more_ranges_and_change_no_device_time():
    from satpu_torch.utils import trace as program

    pre = trace.program_prefixes()
    assert pre[0] == "portbench." and {"yaapt.", "anon.", "asrbn.", "chain."} <= set(pre)
    assert len(pre) == 1 + len({n.split(".", 1)[0] for n in program.NAMES})
    old, new = trace.digest(program_events()), trace.digest(program_events(), pre)
    for key in ("window_us", "busy_us", "items", "by_op"):
        assert new[key] == old[key], key
    assert "yaapt.dynamic5" not in old["inside"]
    assert [n for n, _ in new["inside"]["yaapt.dynamic5"]] == ["shc_band_kernel<4, 21>",
                                                               "gemm_kernel"]
    assert [n for n, _ in new["inside"]["chain.den_forward"]] == ["void den_fwd<4, true>"]
    assert sum(new["idle_by_range"].values()) == sum(old["idle_by_range"].values())
    assert dict(trace.breakdown(new)["idle_gaps"])["yaapt.nlfer"] == pytest.approx(4e-6)


def test_program_prefixes_fall_back_where_the_program_lists_no_families(monkeypatch):
    from satpu_torch.utils import trace as program

    monkeypatch.delattr(program, "NAMES")
    assert trace.program_prefixes() == trace.DEFAULT_PREFIXES == ("portbench.", "chain.")


def test_idle_inside_a_program_span_nested_in_a_benchmark_range():
    """A 100 us window: ``portbench.get_f0`` 0-80 holds ``yaapt.nlfer`` 10-30
    and ``yaapt.dynamic_final`` 40-80; the card is busy 12-20 (launched in
    nlfer) and 45-50 and 60-62 (launched in dynamic_final)."""
    events = [ev(trace.WINDOW, 0, 100), ev("portbench.get_f0", 0, 80),
              ev("yaapt.nlfer", 10, 30), ev("yaapt.dynamic_final", 40, 80),
              ev("cudaLaunchKernel", 11, 12, eid=1), ev("fft", 12, 20, True, 1),
              ev("cudaLaunchKernel", 41, 42, eid=2), ev("add", 45, 50, True, 2),
              ev("cudaLaunchKernel", 55, 56, eid=3), ev("min", 60, 62, True, 3)]
    d = trace.digest(events, trace.program_prefixes())
    gaps = d["idle_by_range"]
    # idle: 0-10 and 30-40 under get_f0 alone, 10-12 and 20-30 in nlfer,
    # 40-45, 50-60, 62-80 in dynamic_final, 80-100 in none
    assert gaps["portbench.get_f0"] == 20
    assert gaps["yaapt.nlfer"] == 12
    assert gaps["yaapt.dynamic_final"] == 33
    assert gaps["(no range)"] == 20
    layer = {"digest": d, "profiled_steps": 1}
    assert trace.launches_inside(layer, ("yaapt.dynamic5", "yaapt.dynamic_final")) == 2
    # the benchmark's own prefixes see none of it
    assert "yaapt.dynamic_final" not in trace.digest(events)["idle_by_range"]


def test_span_ms_reads_recorded_spans_a_step():
    spans = [readercases.span("chain.ng", 1.0), readercases.span("chain.ng", None),
             readercases.span("chain.ng", 3.0), readercases.span("chain.sync", 9.0)]
    assert trace.span_ms({"recorded": {"spans": spans, "steps": 4}}, ("chain.ng",)) == 1.0
    assert trace.span_ms({"recorded": {"spans": spans, "steps": 0}}, ("chain.ng",)) is None
    assert trace.span_ms({"recorded": {"spans": spans, "steps": 4}}, ("chain.den",)) is None
    assert trace.span_ms({"recorded": None}, ("chain.ng",)) is None


def test_recorded_stretch_reports_every_counters_change_and_its_spans():
    """Every counter the program keeps is reported by its change over the
    stretch, one it never named before among them, so a new kernel's
    launches need no edit here."""
    import torch

    program = trace.program_trace()
    program.count("portbench_test.before")
    with trace.recorded(torch, torch.device("cpu"), 3) as rec:
        with program.span("chain.ng"):
            pass
        program.count("portbench_test.new", 2)
    assert rec.launches["steps"] == 3 and rec.launches["portbench_test.new"] == 2
    assert rec.launches["portbench_test.before"] == 0
    assert rec.spans["steps"] == 3 and [s.name for s in rec.spans["spans"]] == ["chain.ng"]


def test_timed_ranges_time_a_modules_ranges_and_restore_them():
    import torch

    opened = []
    module = SimpleNamespace(record_function=lambda name: opened.append(name))
    spans = trace.Spans(torch, torch.device("cpu"))
    with trace.timed_ranges(torch, torch.device("cpu"), module, spans):
        for name in ("chain.net_forward", "chain.ng", "chain.net_forward"):
            with module.record_function(name):
                pass
    assert sorted(spans.host) == ["chain.net_forward", "chain.ng"]
    assert len(spans.host["chain.net_forward"]) == 2 and opened == []
    module.record_function("after")
    assert opened == ["after"]
    bare = SimpleNamespace()
    with trace.timed_ranges(torch, torch.device("cpu"), bare, spans):
        pass
    assert not hasattr(bare, "record_function")
