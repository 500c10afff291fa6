"""The port's remaining CLIs against satpu's on the CPU: ``diff_checkpoints``
prints satpu's lines on the same pair of satpu ``.ckpt`` files (and
reads the port's own files); ``parity`` runs the offline runbook of
``tests/test_parity_cli.py``'s kind (a reference-format ``final.pt`` through
import_model -> anonymize -> eval_anon -> the side-by-side table and
parity.json) with satpu's ``BASELINES``."""
import io
import json
import os

import numpy as np
import pytest

from test_torch_eval_anon import LATTICE_BEAM, NBEST, fx  # noqa: F401  (the eval fixture)
from torch_parity import ASRBN_TINY


def _satpu_pair(tmp_path):
    from satpu.utils.checkpoint import save_checkpoint

    rng = np.random.default_rng(0)
    tree = {"params": {"dense": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                                 "bias": np.zeros(4, np.float32)},
                       "out": {"kernel": rng.standard_normal((4, 2)).astype(np.float32)}},
            "batch_stats": {"bn": {"mean": np.ones(4, np.float32)}}}
    other = {"params": {"dense": {"kernel": tree["params"]["dense"]["kernel"] + 1e-3,
                                  "bias": np.zeros(4, np.float32)},
                        "out": {"kernel": np.zeros((2, 2), np.float32)}},
             "batch_stats": {"bn": {"mean": np.zeros(4, np.float32)}}}
    a, b = str(tmp_path / "a.ckpt"), str(tmp_path / "b.ckpt")
    save_checkpoint(a, {"model_id": "x"}, {"variables": tree})
    save_checkpoint(b, {"model_id": "x"}, {"variables": other})
    return a, b


@pytest.mark.parametrize("keep_bn", [False, True], ids=["skip_bn", "keep_bn"])
def test_diff_checkpoints_prints_satpus_lines(tmp_path, keep_bn):
    from satpu.bin.diff_checkpoints import diff_checkpoints as jdiff
    from satpu_torch.bin.diff_checkpoints import diff_checkpoints

    a, b = _satpu_pair(tmp_path)
    outs = []
    for fn in (jdiff, diff_checkpoints):
        buf = io.StringIO()
        n = fn(a, b, skip_batchnorm=not keep_bn, out=buf)
        outs.append((n, buf.getvalue()))
    assert outs[0] == outs[1]
    assert outs[1][0] == (3 if keep_bn else 2) and "INCOMPATIBLE\tparams.out.kernel" in outs[1][1]


def test_diff_checkpoints_reads_port_files(tmp_path, capsys):
    from satpu_torch import infer_helper
    from satpu_torch.bin import diff_checkpoints

    net = infer_helper.build_model("asrbn_tdnnf", device="cpu", seed=0, **ASRBN_TINY)
    sd = net.state_dict()
    a, b = str(tmp_path / "a.pt"), str(tmp_path / "b.pt")
    infer_helper.save_model(a, "asrbn_tdnnf", dict(ASRBN_TINY), sd)
    changed = "chain_output.weight"
    infer_helper.save_model(b, "asrbn_tdnnf", dict(ASRBN_TINY),
                            {**sd, changed: sd[changed] + 1.0})
    assert diff_checkpoints.main([a, b]) == 0
    lines = capsys.readouterr().out.strip().split("\n")
    assert lines[-1] == "1 tensors differ"
    assert any(x.startswith(f"False\t{changed}\t sum-delta -") for x in lines)
    assert not any(".bn." in x for x in lines)  # batch norms skipped unless kept


def test_parity_runbook_offline(fx, tmp_path):  # noqa: F811
    from satpu.bin.parity import BASELINES as JBASELINES
    from satpu_torch.bin import parity
    from test_torch_distribution import ANON_REF, UTT2SPK, _write_reference

    assert parity.BASELINES == JBASELINES
    pt = str(tmp_path / "final.pt")
    _write_reference(pt, "anonymizer_tdnnf_hifigan", ANON_REF, 0, {"utt2spk": UTT2SPK})
    results = str(tmp_path / "parity_out")
    rc = parity.main([
        "--torch-checkpoint", pt, "--checkpoint", str(tmp_path / "anon.pt"),
        "--data", fx["data"], "--results", results, "--batch-size", "4",
        "--baseline", "vctk_clear", "--device", "cpu",
        # forwarded to eval_anon
        "--asr-checkpoint", fx["asr"], "--decode-graph", fx["graph"], "--words-txt",
        fx["words"], "--nbest", str(NBEST), "--lattice-beam", str(LATTICE_BEAM),
        "--asv-checkpoint", fx["asv"], "--enroll-dir", fx["enroll"], "--trials", fx["trials"]])
    assert rc == 0
    assert os.path.exists(fx["data"] + "_anon/wav.scp")
    rep = json.load(open(os.path.join(results, "parity.json")))
    assert rep["baseline"] == "vctk_clear" and rep["reference"] == JBASELINES["vctk_clear"]
    assert {"wer", "eer", "min_cllr", "linkability"} <= set(rep["measured"])
    assert all(np.isfinite(v) for v in rep["measured"].values())
