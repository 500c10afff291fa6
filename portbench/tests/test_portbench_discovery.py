"""A configuration, a traffic mix and a per-layer metric dropped into their
folders are found by name, with no file that is there edited."""
import hashlib
import json
import os
import shutil

import tiny
from portbench import harness


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
