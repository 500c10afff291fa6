"""Nothing the benchmark imports is JAX or the JAX package (top-level names
compared whole), the reference imports nothing of the port, and a run
without a card refuses."""
import ast
import os
import shutil
import subprocess
import sys

import pytest

import tiny
from portbench import harness

PKG = os.path.join(tiny.ROOT, "portbench")


def sources(sub=""):
    top = os.path.join(PKG, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    """Top-level names of every module ``path`` imports (absolute imports)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


def test_nothing_imports_jax_or_the_jax_package():
    found = {(os.path.relpath(p, tiny.ROOT), m) for p in sources() for m in imported(p)
             if m in harness.FORBIDDEN}
    assert not found


def test_the_reference_imports_nothing_of_the_port():
    found = {(os.path.relpath(p, tiny.ROOT), m) for p in sources("reference")
             for m in imported(p) if m not in ("torch", "numpy", "__future__")
             and m not in sys.stdlib_module_names}
    assert not found


def test_forbidden_names_compare_whole_top_level_names():
    mods = ["satpu_torch", "satpu_torch.ops", "jaxtyping", "flaxen", "satpu", "jax.numpy",
            "flax.linen", "jaxlib.xla_client", "portbench"]
    assert harness.forbidden_modules(mods) == ["flax.linen", "jax.numpy", "jaxlib.xla_client",
                                              "satpu"]


def run(cwd):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "anon_libri_b32",
                           "--seed", "3000000017", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_run_without_a_card_refuses_and_prints_no_result():
    p = run(tiny.ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_run_with_only_the_benchmark_refuses(tmp_path):
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("name", ["command", "paths"])
def test_benchmark_points_inside_its_folder(name):
    b = tiny.bench()
    assert b["paths"] == ["portbench"]
    assert b["command"] == ["python3", "portbench/run.py"]
