"""The B5 cell's job (``jobs/chain_w2v2.py``) at its CPU cut: a sound run,
traced or not, comes out correct and two planted faults do not;
``control.py`` reads it with the front's gap; its counts
(``counts_w2v2.py``) against hand counts at the cell's shortest and longest
allowed lengths; its three readers against their cases."""
import dataclasses
import os

import pytest
import torch

import readercases
import tiny
from portbench import counts_w2v2, harness
from portbench.reference import wav2vec2 as ref_w2v2

CELL = "chain_w2v2_libri100_b16"


@pytest.fixture(autouse=True)
def w2v2_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def w2v2_run(trace=False):
    """A run of the cell at its CPU cut under the configuration's own limits:
    the cut changes the sizes alone, and the sound run reads far under every
    limit (loss1 1e-6, grad 2e-4, front 2e-7 at seed 7), the front in bf16
    over ``front_gap``'s (6e-3 and up) and ``grad_gap``'s."""
    c = tiny.cell(CELL)
    return c.job().run(tiny.context(c, seconds=0.5, trace=trace))


@pytest.mark.parametrize("trace", [False, True])
def test_w2v2_tiny_run_is_correct(trace):
    out = w2v2_run(trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1
    if trace:  # the front's span family names the idle time it holds
        gaps = dict(out["breakdown"]["idle_gaps"])
        assert any(k.startswith("wav2vec2.") for k in gaps), gaps
        assert out["extra"]["launches"]["steps"] >= 1


@pytest.mark.parametrize("how", ["half_batch", "front_bf16"])
def test_w2v2_broken_training_is_not_correct(monkeypatch, how):
    from satpu_torch.chain.trainer import ChainTrainer

    step, grads = ChainTrainer.step, ChainTrainer.compute_grads

    def half(self, wav, graphs, frames, **kw):  # the mean over the first half alone
        h = wav.shape[0] // 2
        return step(self, wav[:h], {k: v[:h] for k, v in graphs.items()}, frames[:h], **kw)

    def bf16(self, *a, **kw):  # the front under the bf16 training policy
        self.opts = dataclasses.replace(self.opts, compute_dtype="bfloat16")
        return grads(self, *a, **kw)

    if how == "half_batch":
        monkeypatch.setattr(ChainTrainer, "step", half)
    else:
        monkeypatch.setattr(ChainTrainer, "compute_grads", bf16)
    out = w2v2_run()
    assert not out["correct"], out["checks"]
    if how == "front_bf16":  # the front's own number reads it
        front = out["checks"]["front_gap"]
        assert front["value"] > front["limit"], front


def test_w2v2_control_readings_hold_the_fronts_gap():
    """``control.py`` reads the cell through the job's own ``gaps``, the
    half-batch fault's front on the rows it took."""
    from portbench import control

    c = tiny.cell(CELL)
    read = control.chain_readings(tiny.context(c, seed=9), c.job())
    assert set(read["front_gap"]) == {"program", "control", "half_batch"}
    assert read["front_gap"]["program"] < c.config["limits"]["front_gap"]
    assert read["loss1_gap"]["half_batch"] > c.config["limits"]["loss1_gap"]


W2V2 = {c["name"]: c for c in tiny.bench()["configs"]}["chain_w2v2_vq48"]
NET = harness.read_json(os.path.join(tiny.ROOT, W2V2["file"]))["build"]


def hand_counts(samples, t, conv_frames, tdnnf):
    """The front's and the net's forward operations written out from the
    published shapes: ``t`` front frames, ``conv_frames`` the extractor's
    frames after each conv, ``tdnnf`` the frames of each TDNN-F layer
    (stage 1's three, stage 2's four, then the heads')."""
    c0, c1, c2, c3, c4, c5, c6 = conv_frames
    assert c6 == t
    convs = 2 * (10 * 512 * c0 + 512 * 3 * 512 * (c1 + c2 + c3 + c4) + 512 * 2 * 512 * (c5 + c6))
    front = (convs + 2 * 512 * 1024 * t + 2 * 64 * 128 * 1024 * t
             + 24 * (8 * 1024 * 1024 * t + 4 * t * t * 1024 + 4 * 1024 * 4096 * t))
    s1, s2 = tdnnf[:3], tdnnf[3:7]
    tdnn = (2 * (3 * 1024 * 128 + 128 * 1024) * (s1[0] + s1[1])
            + 2 * (3 * 1024 * 256 + 256 * 1024) * s1[2]
            + 2 * (1024 * 128 + 128 * 1024) * s2[0]
            + 2 * (3 * 1024 * 128 + 128 * 1024) * (s2[1] + s2[2] + s2[3])
            + 2 * 2 * (1024 * 256 + 256 * 1024 + 1024 * 3280) * s2[3])
    vq = 2 * 256 * 48 * s1[2]
    return front, front + tdnn + vq


@pytest.mark.parametrize("samples, t, conv_frames, tdnnf", [
    # 7.44 s: stage 1 keeps 372 frames (replicate-padded by 3 each side),
    # stage 2 pads 4 each side (380), the 1.5 window gives 253, then 251, 249, 247
    (119040, 371, (23807, 11903, 5951, 2975, 1487, 743, 371), (376, 374, 372, 253, 251, 249, 247)),
    # 19.86 s: 993 frames, 1001 padded, then 667, 665, 663, 661
    (317760, 992, (63551, 31775, 15887, 7943, 3971, 1985, 992), (997, 995, 993, 667, 665, 663, 661)),
])
def test_w2v2_counts_by_hand(samples, t, conv_frames, tdnnf):
    w2v2 = NET["wav2vec2"]
    front, net = hand_counts(samples, t, conv_frames, tdnnf)
    assert counts_w2v2.front_frames(w2v2, samples) == t
    assert ref_w2v2.chain_frames(samples, NET, w2v2) == tdnnf[-1]
    assert counts_w2v2.front_flops(w2v2, samples) == front
    assert counts_w2v2.net_flops(NET, samples) == net
    assert counts_w2v2.train_step_flops(NET, [samples] * 16) == 3 * 16 * net
    # the attention: 4 B T'^2 d forward, twice that backward, a layer, at a
    # third of the TF32 peak (its bytes bound it less)
    want = 24 * 3 * 4 * 16 * t * t * 1024 / (495e12 / 3)
    assert counts_w2v2.attention_bound_s(w2v2, 16, samples) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["w2v2_front_ms.train", "w2v2_conv_ms.train",
                                  "w2v2_attn_roofline.train"])
def test_w2v2_reader_case(name):
    readercases.check(name)
