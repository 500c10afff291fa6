"""The trace digest and every per-layer reader on a synthetic event list."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

import tiny
from portbench import harness, trace


def ev(name, start, end, device=False, eid=0, annotation=False):
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


def layer():
    spans = SimpleNamespace(device_ms={"get_f0": [2.0, 4.0], "convert": [5.0]},
                            host={"load": [1.0, 3.0], "chain.net_forward": [0.1, 0.05],
                                  "chain.net_backward": [0.05], "chain.objective_forward": [0.3],
                                  "chain.objective_backward": [0.1], "chain.ng": [0.06],
                                  "chain.optimizer": [0.04]})
    # busy 235 us of the trace for 1 ms of audio, at 2 audio-s/s untraced
    return {"digest": trace.digest(events()), "spans": spans, "phase_steps": 2,
            "k1_bound_s": 10e-6, "den_bound_s": 25e-6, "mfu": 0.125,
            "traced_audio_s": 1e-3, "audio_s_per_s": 2.0}


EXPECTED = {
    "f0_span_ms.serve": 3.0, "convert_span_ms.serve": 5.0, "k1_roofline.serve": 50.0,
    "mfu.serve": 12.5, "idle_share.serve": 53.0, "load_ms.train": 2.0,
    "net_ms.train": 0.1, "objective_ms.train": 0.2, "ng_opt_ms.train": 0.05,
    "k2_roofline.train": 25.0, "mfu.train": 12.5, "idle_share.train": 53.0,
}


def test_every_declared_metric_has_a_reader_checked_here():
    assert {m["name"] for m in tiny.bench()["per_layer"]} == set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_by_hand(name):
    c = harness.Cell(tiny.bench(), "anon_libri_b32", tiny.ROOT)
    assert c.reader(name).read(layer()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_that_finds_nothing_returns_nothing(name):
    c = harness.Cell(tiny.bench(), "anon_libri_b32", tiny.ROOT)
    empty = {"digest": trace.digest([]), "phase_steps": 1, "k1_bound_s": 1e-6,
             "den_bound_s": 1e-6, "mfu": None, "traced_audio_s": 0.0, "audio_s_per_s": 2.0,
             "spans": SimpleNamespace(device_ms={}, host={})}
    assert c.reader(name).read(empty) is None


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
