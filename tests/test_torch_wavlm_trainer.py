"""The ASV train step (``sidekit.trainer.AsvTrainer``) with the WavLM
frontend against satpu's (``init_asv_state`` + ``make_asv_train_step``)
on the CPU: a small large-style WavLM (hidden 32, 2 layers, 4 heads) feeding
the ECAPA (32 channels) or the half-ResNet, 16-d embeddings over 4
speakers, B=8 x 8000 samples, from satpu's initial weights carried across
by the bridge. The WavLM frontend is trained with the trunk, so the port's
step runs from the audio (no SpecAugment on this frontend).

- ECAPA, 3 steps at f32 with a one-cycle schedule (lr 5e-3 over 10 steps):
  losses rel 1e-4 (6e-6 measured), accuracy equal, every parameter and
  batch-norm statistic rel 1e-4 (8.4e-5 measured) but the tensors whose
  gradient is zero in exact arithmetic, which Adam moves by rounding noise
  of up to lr a step: the attention's key biases (a constant over the keys
  of a softmax row), the final encoder layer norm's bias (a constant over
  time that the frontend's instance norm removes) and the pooling
  attention's last bias (PR 7's);
- half-ResNet, 3 steps (lr 1e-4, the same schedule shape), held as PR 8
  held the speaker-adversarial net's train-mode half-ResNet (a ReLU input
  within rounding of zero takes either branch, and Adam turns a gradient
  under the rounding into a full-size update): losses rel 1e-3 (2e-4
  measured), every parameter within 1e-5 of its tensor's largest entry
  plus twice the lr summed over the steps, and at most 1% of the entries
  beyond 1e-5 of the largest plus 1e-2 x that sum (0.87% measured);
- satpu's bf16 policy covers the WavLM frontend: its linears and convs run
  in bf16 inside the step, its parameters (``feature_weight`` too) get f32
  gradients and move, and the losses follow satpu's rule (the first within
  5% of f32's and of satpu's bf16 first loss, then falling).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from torch_parity import jax_variables_numpy, rel_err

B, T, STEPS = 8, 8000, 3
WAVLM = dict(conv_dim=(16, 16, 16), conv_kernel=(10, 8, 4), conv_stride=(5, 8, 8),
             hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
             num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, num_buckets=32,
             max_bucket_distance=50, feat_extract_norm="layer", conv_bias=True)
XV = dict(num_speakers=4, channels=32, embedding_size=16, frontend="wavlm")
ZERO_GRAD = ("attention.k_proj.bias", "preprocessor.feature_extract.encoder.layer_norm.bias",
             "stat_pooling.linear2.bias")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T)) * 0.1).astype(np.float32), (np.arange(B) % 4).astype(
        np.int32)


def _satpu(arch, wav, target, lr, steps, dtype="float32"):
    """satpu's (initial variables, [loss], final variables), numpy."""
    from satpu.models.wavlm import WavLMConfig
    from satpu.sidekit.trainer import init_asv_state, make_asv_optimizer, make_asv_train_step
    from satpu.sidekit.xvector import XVectorConfig, build_xvector
    from satpu.utils.schedules import one_cycle

    model = build_xvector(XVectorConfig(arch=arch, wavlm=WavLMConfig(**WAVLM), **XV))
    optimizer = make_asv_optimizer(lr=lr)
    state = init_asv_state(model, jax.random.PRNGKey(0), wav, optimizer)
    v0 = jax_variables_numpy({"params": state.params, "batch_stats": state.batch_stats})
    step = jax.jit(make_asv_train_step(model, optimizer, lr_schedule=one_cycle(lr, 10),
                                       compute_dtype=dtype))
    losses = []
    for i in range(steps):
        state, m = step(state, wav, target, jax.random.PRNGKey(i))
        losses.append((float(m["loss"]), float(m["accuracy"])))
    return v0, losses, jax_variables_numpy({"params": state.params,
                                            "batch_stats": state.batch_stats})


def _port(arch, v0, wav, target, lr, steps, dtype="float32"):
    from satpu_torch.models.convert import from_satpu_xvector
    from satpu_torch.sidekit.trainer import AsvTrainer, make_asv_optimizer
    from satpu_torch.sidekit.xvector import XVectorConfig, build_xvector
    from satpu_torch.utils.schedules import one_cycle

    model = build_xvector(XVectorConfig(arch=arch, wavlm=dict(WAVLM), **XV))
    model.load_state_dict(from_satpu_xvector(v0))
    trainer = AsvTrainer(model, make_asv_optimizer(model, lr=lr),
                         lr_schedule=one_cycle(lr, 10), compute_dtype=dtype)
    losses = []
    for _ in range(steps):
        m = trainer.train_step(torch.from_numpy(wav), torch.from_numpy(target).long())
        losses.append((float(m["loss"]), float(m["accuracy"])))
    return losses, model


def test_ecapa_three_steps_match_satpu():
    from satpu_torch.models.convert import from_satpu_xvector

    lr = 5e-3
    wav, target = _batch()
    v0, ref, v3 = _satpu("ecapa", wav, target, lr, STEPS)
    out, model = _port("ecapa", v0, wav, target, lr, STEPS)
    for (loss, acc), (jloss, jacc) in zip(out, ref):
        assert abs(loss - jloss) <= 1e-4 * abs(jloss), (loss, jloss)
        assert acc == jacc
    assert ref[-1][0] < ref[0][0]  # it trains
    want, start, got = from_satpu_xvector(v3), from_satpu_xvector(v0), model.state_dict()
    assert set(got) == set(want)
    zero = [k for k in want if k.endswith(ZERO_GRAD)]
    assert len(zero) == 4
    for k, w in want.items():
        if k in zero:  # Adam moves noise by up to lr a step
            lim = STEPS * lr * (1 + 1e-3)
            assert (got[k] - start[k]).abs().max() <= lim and (w - start[k]).abs().max() <= lim
        else:
            assert rel_err(got[k].numpy(), w.numpy()) <= 1e-4, k
    moved = [k for k in want if k.startswith("preprocessor.") and k not in zero
             and not torch.equal(got[k], start[k])]
    assert "preprocessor.feature_weight" in moved and len(moved) > 30  # the frontend trains


def test_resnet_three_steps_match_satpu():
    from satpu_torch.models.convert import from_satpu_xvector

    lr = 1e-4
    wav, target = _batch()
    v0, ref, v3 = _satpu("resnet", wav, target, lr, STEPS)
    out, model = _port("resnet", v0, wav, target, lr, STEPS)
    for (loss, _), (jloss, _) in zip(out, ref):
        assert abs(loss - jloss) <= 1e-3 * abs(jloss), (loss, jloss)
    assert ref[-1][0] < ref[0][0]
    want, got = from_satpu_xvector(v3), model.state_dict()
    span = STEPS * lr
    beyond, total = 0, 0
    for k, w in want.items():
        d, scale = (got[k] - w).abs(), float(w.abs().max())
        assert float(d.max()) <= 1e-5 * scale + 2 * span, k
        beyond += int((d > 1e-5 * scale + 1e-2 * span).sum())
        total += w.numel()
    assert beyond <= 0.01 * total, beyond / total


def test_bf16_policy_covers_the_wavlm_frontend():
    from satpu_torch.models.convert import from_satpu_xvector
    from satpu_torch.sidekit.trainer import AsvTrainer, make_asv_optimizer
    from satpu_torch.sidekit.xvector import XVectorConfig, build_xvector

    lr = 5e-3
    wav, target = _batch(seed=1)
    v0, ref_bf16, _ = _satpu("ecapa", wav, target, lr, 1, dtype="bfloat16")
    f32, _ = _port("ecapa", v0, wav, target, lr, 4)
    bf16, _ = _port("ecapa", v0, wav, target, lr, 4, dtype="bfloat16")
    f32, bf16 = [m[0] for m in f32], [m[0] for m in bf16]
    assert np.isfinite(bf16).all()
    assert abs(bf16[0] - f32[0]) / abs(f32[0]) < 0.05, (f32[0], bf16[0])
    assert abs(bf16[0] - ref_bf16[0][0]) / abs(ref_bf16[0][0]) < 0.05
    assert min(bf16[1:]) < bf16[0], bf16

    model = build_xvector(XVectorConfig(wavlm=dict(WAVLM), **XV))
    model.load_state_dict(from_satpu_xvector(v0))
    trainer = AsvTrainer(model, make_asv_optimizer(model, lr=lr), compute_dtype="bfloat16")
    front = model.preprocessor.feature_extract
    seen = {}

    def record(name):
        def hook(module, inputs, output):
            seen.setdefault(name, output.dtype)
        return hook

    watched = (("q_proj", front.encoder.layers[0].attention.q_proj),
               ("conv0", front.feature_extractor.conv_layers[0].conv),
               ("layer_norm", front.encoder.layers[0].layer_norm))
    hooks = [m.register_forward_hook(record(name)) for name, m in watched]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    trainer.train_step(torch.from_numpy(wav), torch.from_numpy(target).long())
    for h in hooks:
        h.remove()
    assert seen == {"q_proj": torch.bfloat16, "conv0": torch.bfloat16,
                    "layer_norm": torch.float32}
    for p in model.preprocessor.parameters():
        assert p.dtype == torch.float32 and p.grad is not None and p.grad.dtype == torch.float32
    assert float(model.preprocessor.feature_weight.grad.abs().max()) > 0
    after = model.state_dict()
    assert not torch.equal(after["preprocessor.feature_weight"],
                           before["preprocessor.feature_weight"])
    assert not torch.equal(after["preprocessor.feature_extract.encoder.layers.0.attention."
                                 "q_proj.weight"],
                           before["preprocessor.feature_extract.encoder.layers.0.attention."
                                  "q_proj.weight"])
    assert dataclasses.asdict(model.preprocessor.feature_extract.cfg)["hidden_size"] == 32
