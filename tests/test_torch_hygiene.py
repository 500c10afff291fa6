"""satpu_torch stands alone: no file of the port (nor chip_smoke.py)
imports jax, flax or satpu, importing its CLI loads no jax, and its entry
points refuse to run on the CPU unless asked to."""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "satpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "satpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_flax_or_satpu_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_cli_import_leaves_jax_unloaded():
    code = ("import sys, satpu_torch.bin.anonymize, satpu_torch.bin.pipeline, "
            "satpu_torch.infer_helper, satpu_torch.bin.train_asr, satpu_torch.chain, "
            "satpu_torch.chain.trainer, satpu_torch.chain.dataset, satpu_torch.chain.prep\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'satpu')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_build_model_defaults_to_cuda(monkeypatch):
    from satpu_torch import infer_helper
    from torch_parity import ANON_TINY, ASRBN_TINY

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer_helper.build_model("anonymizer_tdnnf_hifigan", asrbn=dict(ASRBN_TINY),
                                 **ANON_TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer_helper.load_model(os.path.join(ROOT, "no-such.pt"))
    model = infer_helper.build_model("asrbn_tdnnf", device="cpu", **ASRBN_TINY)
    assert next(model.parameters()).device.type == "cpu"
