"""A configuration, a traffic mix, a job, a per-layer metric with its case
and a span family of the program's are found by name, with no file that is
there edited."""
import hashlib
import json
import os
import shutil

import pytest

import readercases
import tiny
from portbench import harness, trace


def digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_and_entries_are_found(tmp_path):
    shutil.copytree(os.path.join(tiny.ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(tmp_path / "portbench")
    bench = tiny.bench()
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "anon_tdnnf_vq48_bf16.json").read_text())
    cfg["build"]["num_speakers"] = 11
    (pb / "configs" / "anon_new.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "anon_libri.json").read_text())
    mix["utterances"] = 64
    (pb / "traffic" / "anon_short.json").write_text(json.dumps(mix))
    (pb / "metrics" / "batches.serve.py").write_text(
        "def read(layer):\n    return 42.0\n")
    bench["configs"].append({"name": "anon_new", "source": "x",
                             "file": "portbench/configs/anon_new.json", "reduced": [],
                             "why": "y"})
    bench["workloads"].append({"name": "anon_new_short", "config": "anon_new",
                               "traffic": "anon_short", "chips": 1, "why": "z"})
    bench["end_to_end"][1]["workloads"].append("anon_new_short")
    bench["per_layer"].append({"name": "batches.serve", "unit": "count", "better": "higher",
                               "source": "program_counter", "layer": "whole step",
                               "moves": "serve_audio_s_per_s", "workloads": ["anon_new_short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert digests(pb).items() >= before.items()  # nothing there was changed

    cell = harness.Cell(harness.benchmark(str(tmp_path)), "anon_new_short", str(tmp_path))
    assert cell.config["build"]["num_speakers"] == 11
    assert cell.traffic["utterances"] == 64
    assert [m["name"] for m in cell.per_layer] == ["batches.serve"]
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "serve_audio_s_per_s"]
    assert cell.reader("batches.serve").read({}) == 42.0
    assert cell.job().run is not None


def test_metric_without_workloads_follows_what_it_moves():
    bench = tiny.bench()
    bench["per_layer"].append({"name": "x.train", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "network",
                               "moves": "train_audio_s_per_s"})
    chain = harness.Cell(bench, "chain_libri100_b16", tiny.ROOT)
    serve = harness.Cell(bench, "anon_libri_b32", tiny.ROOT)
    assert "x.train" in [m["name"] for m in chain.per_layer]
    assert "x.train" not in [m["name"] for m in serve.per_layer]


# a job of its own: its CPU cut, and a run that opens a span of a family
# that no file of the benchmark names, profiled and recorded
ECHO_JOB = '''"""A job that scales a vector inside one span of the program."""
from portbench import harness, trace


def tiny(cfg, mix):
    cfg["width"], mix["requests"] = 8, 4
    return cfg, mix


def run(ctx):
    from satpu_torch.utils.trace import span

    torch, dev = ctx.torch, ctx.device
    x = torch.ones(ctx.cell.config["width"], device=dev)
    with trace.profiled(torch, dev, trace.program_prefixes()) as traced:
        with span("w2v2.attention"):
            x = x * 2
    with trace.recorded(torch, dev, 1) as rec:
        with span("w2v2.attention"):
            x = x * 2
    layer = {"digest": traced.digest, "recorded": rec.spans}
    return {"metrics": harness.read_layers(ctx.cell, layer), "layer": layer,
            "breakdown": trace.breakdown(traced.digest)}
'''
READER = '''from portbench.trace import span_ms


def read(layer):
    return span_ms(layer, ("w2v2.attention",))
'''
CASE = '''import readercases as rc
from readercases import empty  # noqa: F401

EXPECTED = 4.0


def layer():
    return rc.layer(recorded={"steps": 2, "spans": [rc.span("w2v2.attention", 3.0),
                                                    rc.span("w2v2.attention", 5.0)]})
'''


def test_new_job_metric_and_span_family_arrive_as_new_files(tmp_path, monkeypatch):
    """In a copy: a configuration whose job is a new file with its own CPU
    cut, a per-layer metric with its reader and case on spans of a family
    the digest has never seen, and a declared metric without a case."""
    pb = tmp_path / "portbench"
    shutil.copytree(os.path.join(tiny.ROOT, "portbench"), pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(pb)
    (pb / "jobs" / "echo.py").write_text(ECHO_JOB)
    (pb / "configs" / "echo_w2v2.json").write_text(json.dumps({"job": "echo", "width": 1024}))
    (pb / "traffic" / "echo_burst.json").write_text(json.dumps({"requests": 4096}))
    for name in ("w2v2_ms.train", "nocase.train"):
        (pb / "metrics" / (name + ".py")).write_text(READER)
    (pb / "metrics" / "cases" / "w2v2_ms.train.py").write_text(CASE)
    bench = tiny.bench()
    bench["configs"].append({"name": "echo_w2v2", "source": "x", "reduced": [], "why": "y",
                             "file": "portbench/configs/echo_w2v2.json"})
    bench["workloads"].append({"name": "echo_burst", "config": "echo_w2v2",
                               "traffic": "echo_burst", "chips": 1, "why": "z"})
    for name in ("w2v2_ms.train", "nocase.train"):
        bench["per_layer"].append({"name": name, "unit": "ms", "better": "lower",
                                   "source": "program_span", "layer": "front",
                                   "moves": "setup_s", "workloads": ["echo_burst"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    assert digests(pb).items() >= before.items()  # nothing there was changed

    c = tiny.cell("echo_burst", root=str(tmp_path))
    assert (c.config["width"], c.traffic["requests"]) == (8, 4)
    readercases.check("w2v2_ms.train", str(tmp_path))
    with pytest.raises(pytest.fail.Exception, match="'nocase.train' has no case"):
        readercases.check("nocase.train", str(tmp_path))

    # the program adds the family to its NAMES: the digest names its range
    from satpu_torch.utils import trace as program

    monkeypatch.setattr(program, "NAMES", program.NAMES + ("w2v2.attention",))
    out = c.job().run(tiny.context(c))
    assert "w2v2.attention" in dict(out["breakdown"]["idle_gaps"])
    assert [s.name for s in out["layer"]["recorded"]["spans"]] == ["w2v2.attention"]
    monkeypatch.undo()
    assert "w2v2.attention" not in dict(c.job().run(tiny.context(c))["breakdown"]["idle_gaps"])
