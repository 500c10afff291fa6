"""The B5 extractor's wav2vec2 front and chain step on the CPU, against the
explicit softmax and against the benchmark's plain reference
(``portbench/reference/wav2vec2.py``, plain torch written from the published
architecture), on seeded random weights:

- the fused attention (``F.scaled_dot_product_attention``) against the
  explicit softmax(q k^T) v it replaced, in f32 and under the bf16 policy,
  forward and, in f32, backward;
- the front's features and frame arithmetic against the reference's, at a
  2-layer, width-32 front with the published kernels and strides at 16
  channels;
- three ``ChainTrainer`` steps of ``Wav2Vec2TDNNFNet`` (no bottleneck,
  natural gradient on, the front's update factor from ``train_asr``)
  against the reference's ``FrontChainTrainer`` from the same weights, NG
  states and batches over a 5-phone random-bigram den graph: each step's
  loss, each parameter's step-1 gradient and its change after the steps.
  Running the port's front under the bf16 policy fails these tolerances;
- the ``wav2vec2.*`` spans under ``trace.recording()``: one ``wav2vec2.front``
  holding one ``wav2vec2.conv``, one ``wav2vec2.pos_conv`` and, per layer, one
  ``wav2vec2.attention`` and one ``wav2vec2.ffn``; in a chain step the front is a
  child of ``chain.net_forward``.
"""
import copy
import functools
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.reference import asrbn as ref_asrbn  # noqa: E402
from portbench.reference import fst as ref_fst  # noqa: E402
from portbench.reference import objf as ref_objf  # noqa: E402
from portbench.reference import prep as ref_prep  # noqa: E402
from portbench.reference import trainer as ref_trainer  # noqa: E402
from portbench.reference import wav2vec2 as ref_w2v2  # noqa: E402
from satpu_torch.models import wav2vec2  # noqa: E402
from satpu_torch.models.torchlayers import autocast  # noqa: E402
from satpu_torch.utils import trace  # noqa: E402

# a 2-layer front of width 32 with the published kernels and strides at 16
# channels, before a TDNN-F of 32 over the 40 pdfs of a 5-phone den graph
FRONT = {"conv_dim": [16] * 7, "conv_kernel": [10, 3, 3, 3, 3, 2, 2],
         "conv_stride": [5, 2, 2, 2, 2, 2, 2], "hidden_size": 32, "num_hidden_layers": 2,
         "num_attention_heads": 4, "intermediate_size": 64, "num_conv_pos_embeddings": 16,
         "num_conv_pos_embedding_groups": 4, "do_stable_layer_norm": True,
         "layer_norm_eps": 1e-5, "feat_extract_norm": "layer", "conv_bias": True}
NET = {"output_dim": 40, "hidden_dim": 32, "bottleneck_dim": 16, "prefinal_bottleneck_dim": 16,
       "kernel_size_list": (3, 3, 3), "subsampling_factor_list": (1, 1, 1),
       "kernel_size_list_after": (1, 3, 3, 3),
       "subsampling_factor_list_after": (1.5, 1, 1, 1), "bottleneck": "none",
       "natural_gradient": True}


def rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).norm() / b.norm())


def explicit_attention(attn, x):
    """softmax(q k^T) v written out, the softmax in f32 and cast back to the
    logits' dtype: the attention the fused call replaced."""
    B, T, d = x.shape
    H = attn.num_heads
    hd = d // H

    def split(t):
        return t.reshape(B, T, H, hd).transpose(1, 2)

    q = attn.q_proj(x) * (hd ** -0.5)
    s = split(q) @ split(attn.k_proj(x)).transpose(-1, -2)
    p = torch.softmax(s.to(torch.promote_types(s.dtype, torch.float32)), dim=-1).to(s.dtype)
    return attn.out_proj((p @ split(attn.v_proj(x))).transpose(1, 2).reshape(B, T, d))


@pytest.fixture
def attention():
    torch.manual_seed(0)
    cfg = wav2vec2.Wav2Vec2Config(hidden_size=64, num_attention_heads=4)
    attn = wav2vec2.SelfAttention(cfg)
    x = torch.randn(2, 53, 64)
    return attn, x


def test_fused_attention_matches_the_explicit_softmax_in_f32(attention):
    """f32: the two sum in other orders, rel <= 1e-6 forward and 1e-5 in the
    input's and every weight's gradient (f32 rounds to 6e-8; 53 keys a
    row). The key bias's gradient is zero in exact arithmetic (it shifts a
    row's scores alike, which the softmax cancels): both read under 1e-5
    of the key weight's."""
    attn, x = attention
    x1, x2 = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    fused, plain = attn(x1), explicit_attention(attn, x2)
    assert rel(fused, plain) <= 1e-6
    g = torch.randn_like(fused)
    names = ["input"] + [n for n, _ in attn.named_parameters()]
    grads_f = dict(zip(names, torch.autograd.grad(fused, [x1, *attn.parameters()], g)))
    grads_p = dict(zip(names, torch.autograd.grad(plain, [x2, *attn.parameters()], g)))
    for n in names:
        if n == "k_proj.bias":
            scale = float(grads_p["k_proj.weight"].norm())
            assert max(float(grads_f[n].norm()), float(grads_p[n].norm())) <= 1e-5 * scale
        else:
            assert rel(grads_f[n], grads_p[n]) <= 1e-5, n


def test_fused_attention_under_the_bf16_policy(attention):
    """Under ``autocast(bf16)`` both compute the projections in bf16 and the
    softmax in f32: each within 3e-2 of the f64 attention (bf16 rounds to
    2^-8; the tolerance of ``test_torch_wav2vec2.py``'s bf16 policy), and
    within 3e-2 of each other."""
    attn, x = attention
    with torch.no_grad():
        with autocast(torch.bfloat16):
            fused, plain = attn(x), explicit_attention(attn, x)
        exact = explicit_attention(attn.double(), x.double())
    assert fused.dtype == plain.dtype == torch.bfloat16
    assert rel(fused, exact) <= 3e-2 and rel(plain, exact) <= 3e-2
    assert rel(fused, plain) <= 3e-2


def tiny_models():
    """The port's net, its norms moved off 1 and 0 so that a mis-mapped norm
    shows, and the reference's net with the same state."""
    from satpu_torch import infer_helper

    port = infer_helper.build_model("asrbn_tdnnf_wav2vec2", device="cpu", seed=0,
                                    wav2vec2=FRONT, **NET)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for n, p in port.named_parameters():
            if "layer_norm" in n:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    ref = ref_w2v2.Wav2Vec2TDNNFNet(ref_asrbn.TDNNFNetConfig(**NET), FRONT)
    ref.load_state_dict(port.state_dict())
    return port.eval(), ref.eval()


def test_front_features_and_frames_match_the_reference():
    """The padded front features, f32 on both sides: rel <= 1e-5 (sums in
    other orders over 2 layers); the chain frames of the reference's
    arithmetic equal the port's network output at the cell's shortest and
    longest allowed lengths and between them."""
    port, ref = tiny_models()
    wav = torch.from_numpy((np.random.default_rng(0).standard_normal((2, 25440)) * 0.1)
                           .astype(np.float32))
    with torch.no_grad():
        assert rel(port.features(wav), ref.features(wav)) <= 1e-5
        for n in (119040, 25440, 12960, 317760):
            out = port(torch.zeros(1, n))[0]
            assert out.shape[1] == ref_w2v2.chain_frames(n, NET, FRONT), n
            assert ref_w2v2.num_frames(n) == wav2vec2.num_frames(n), n


STEPS, BATCH, SAMPLES, TOTAL = 3, 2, 19200, 100
OPTS = dict(lr=3e-4, xent_regularize=0.025, l2_regularize=1e-4, leaky_hmm_coefficient=1e-5)


def chain_batches(tmp_path):
    """The den graph as the port reads it from its file and as the reference
    holds it, and ``STEPS`` batches of noise with numerators of random phone
    walks (a third of the egs' output frames long)."""
    from satpu_torch.chain.fst import Fst
    from satpu_torch.chain.objf import DenominatorGraph

    den, tree, trans = ref_prep.random_bigram_den(5, 3, seed=2)
    den.write(str(tmp_path / "den.fst"))
    port_den = DenominatorGraph.from_fst(Fst.read(str(tmp_path / "den.fst")), tree.num_pdfs)
    rng = np.random.default_rng(11)
    # the numerator's frames as the egs count them (10 ms frames, then 3x)
    frames = np.full(BATCH, ((SAMPLES + 80) // 160 - 2) // 3, np.int32)
    batches = []
    for _ in range(STEPS):
        walks = [ref_prep.random_phone_walk(trans, int(frames[0]) // 3, rng)
                 for _ in range(BATCH)]
        graphs = ref_fst.pad_graph_arrays([ref_fst.fst_to_arrays(ref_fst.fst_rmepsilon(
            ref_prep.numerator_fst(w, tree))) for w in walks])
        wav = (rng.standard_normal((BATCH, SAMPLES)) * 0.1).astype(np.float32)
        batches.append((torch.from_numpy(wav), graphs, torch.from_numpy(frames)))
    return port_den, ref_objf.DenominatorGraph.from_fst(den, tree.num_pdfs), batches


def stepped(trainer, params, w0, batches, to_graphs):
    """Steps ``trainer`` over ``batches``: (each step's loss, each
    parameter's step-1 gradient norm from AdamW's first moment, each
    parameter's change norm after the steps)."""
    losses = []
    for wav, graphs, frames in batches:
        losses.append(float(trainer.step(wav, to_graphs(graphs, "cpu"), frames)["loss"]))
        if len(losses) == 1:
            beta1 = trainer.optimizer.param_groups[0]["betas"][0]
            grads = torch.stack([trainer.optimizer.state[p]["exp_avg"].norm() / (1 - beta1)
                                 for _, p in params]).double()
    return losses, grads, torch.stack([(p.detach() - w0[n]).norm() for n, p in params]).double()


def chain_gaps(tmp_path, compute_dtype="float32", record=False):
    """The gaps of the port's first three steps from the reference's: the
    worst step's relative loss gap, and the worst parameter's gap of its
    step-1 gradient norm and of its change norm, each over the larger of its
    own reference norm and the median parameter's; with ``record``, also the
    spans of a fourth step of the port."""
    from satpu_torch.bin.train_asr import wav2vec2_update_factor
    from satpu_torch.chain.objf import graphs_to_torch
    from satpu_torch.chain.trainer import ChainTrainer, ChainTrainOpts, init_ng_states

    port, ref = tiny_models()
    port.train(), ref.train()
    w0 = {n: p.detach().clone() for n, p in port.named_parameters()}
    port_den, ref_den, batches = chain_batches(tmp_path)
    ng0 = init_ng_states(port, seed=3)

    def lr(step):
        return OPTS["lr"] * 0.5 ** (step / TOTAL)

    def front_factor(step):  # the recipe's: 1/20, 1/5 from a tenth, 0 from nine tenths
        frac = step / TOTAL
        return 1 / 20 if frac < 0.1 else 1 / 5 if frac < 0.9 else 0.0

    mine = ChainTrainer(port, port_den, ChainTrainOpts(compute_dtype=compute_dtype, **OPTS),
                        lr_schedule=lr, seed=5, ng_states=ng0,
                        preprocessor_schedule=functools.partial(wav2vec2_update_factor,
                                                                total_steps=TOTAL))
    want = ref_w2v2.FrontChainTrainer(ref, ref_den, ref_trainer.ChainTrainOpts(**OPTS),
                                      lr_schedule=lr, seed=5, ng_states=copy.deepcopy(ng0),
                                      front_factor=front_factor)
    port_params, ref_params = list(port.named_parameters()), list(ref.named_parameters())
    l1, g1, c1 = stepped(mine, port_params, w0, batches, graphs_to_torch)
    l2, g2, c2 = stepped(want, ref_params, w0, batches, ref_objf.graphs_to_torch)
    spans = None
    if record:
        with trace.recording(events=False):
            mine.step(batches[0][0], graphs_to_torch(batches[0][1], "cpu"), batches[0][2])
        spans = trace.collect()

    def per_leaf(a, b):
        return float(((a - b).abs() / b.clamp(min=float(b.median()))).max())

    # a parameter whose gradient is rounding (under a thousandth of the
    # median one's: the key bias, a bias before a norm) moves by Adam's
    # full step whatever its sign, so its change is left out
    keep = g2 >= 1e-3 * float(g2.median())
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(l1, l2)),
            "grad_gap": per_leaf(g1, g2), "change_gap": per_leaf(c1[keep], c2[keep])}, spans


# (limit, reason): f32 on both sides, sums in other orders; each well
# above the reading and far below the bf16 front's (loss 6.1e-4, gradient
# 0.37, change 0.10)
TOLERANCES = {"loss_gap": (1e-4, "the worst of three losses; 4.2e-7 read"),
              "grad_gap": (1e-3, "the worst parameter's step-1 gradient; 6.1e-6 read"),
              "change_gap": (1e-2, "the worst parameter's change after three steps; 9.0e-5 "
                                   "read")}


def test_three_chain_steps_match_the_reference(tmp_path):
    got, spans = chain_gaps(tmp_path, record=True)
    for k, (limit, why) in TOLERANCES.items():
        assert got[k] <= limit, (k, got[k], why)
    front = [s for s in spans if s.name == "wav2vec2.front"]
    outer = {s.id: s.name for s in spans}
    assert len(front) == 1 and outer[front[0].parent] == "chain.net_forward"


def test_the_front_in_bf16_fails_the_tolerances(tmp_path):
    got, _ = chain_gaps(tmp_path, "bfloat16")
    assert any(got[k] > limit for k, (limit, _) in TOLERANCES.items()), got


def test_w2v2_spans_nest_in_the_front():
    cfg = wav2vec2.Wav2Vec2Config(conv_dim=(8,) * 7, hidden_size=32, num_hidden_layers=3,
                                  num_attention_heads=4, intermediate_size=64,
                                  num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    model = wav2vec2.Wav2Vec2Model(cfg)
    with torch.no_grad(), trace.recording(events=False):
        model(torch.zeros(2, 8000))
    spans = trace.collect()
    names = [s.name for s in spans]
    assert {n: names.count(n) for n in set(names)} == {
        "wav2vec2.front": 1, "wav2vec2.conv": 1, "wav2vec2.pos_conv": 1, "wav2vec2.attention": 3, "wav2vec2.ffn": 3}
    front = next(s for s in spans if s.name == "wav2vec2.front")
    assert front.parent is None
    assert all(s.parent == front.id for s in spans if s is not front)
    layers = [s for s in spans if s.name in ("wav2vec2.attention", "wav2vec2.ffn")]
    assert [s.name for s in sorted(layers, key=lambda s: s.start_ns)] == [
        "wav2vec2.attention", "wav2vec2.ffn"] * 3
