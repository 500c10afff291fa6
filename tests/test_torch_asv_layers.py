"""satpu_torch's ASV layers in training mode against satpu's on the CPU at
f32, from the same weights (carried across by the weight bridge, with
randomized batch-norm statistics and affines) and the same numpy inputs:

- batch norm in training mode (1-D and 2-D): output, updated running
  statistics, input and parameter gradients, rel 1e-4;
- the ECAPA and half-ResNet trunks and AttentivePooling with global context
  in training mode: the same, rel 1e-4; GruPooling and
  ChannelWiseCorrPooling: rel 1e-4;
- the six loss heads: loss, logits and the gradients with respect to the
  input and the head's parameters, 1e-5;
- the SpecAugment masks: satpu's ``spec_masking`` draws, applied by
  ``apply_spec_masks``, exact;
- the bf16 policy: which layers run in bf16.

A tensor whose satpu gradient is zero up to rounding (a bias under a
softmax over time) is held to 1e-6 absolute instead."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import bridged, jax_variables_numpy, rel_err, satpu_init

ZERO_GRAD = 1e-6  # a gradient below this (max abs) is rounding: held in abs


def _close(out, ref, tol):
    """rel_err within tol, or for a zero-up-to-rounding ref, abs within
    ZERO_GRAD."""
    ref = np.asarray(ref, np.float64)
    if np.abs(ref).max() < ZERO_GRAD:
        return float(np.abs(np.asarray(out) - ref).max()) <= ZERO_GRAD
    return rel_err(out, ref) <= tol


def _to_port(x):
    """satpu channels-last [B, T, C] / [B, F, T, C] -> [B, C, T] / [B, C, F, T]
    ([B, D] unchanged)."""
    x = np.asarray(x)
    perm = {2: (0, 1), 3: (0, 2, 1), 4: (0, 3, 1, 2)}[x.ndim]
    return np.ascontiguousarray(x.transpose(perm))


def _train_mode(jm, pm, x, seed=0, tol=1e-4, grad_tol=None):
    """jm / pm in training mode on satpu-layout ``x``: output, running
    statistics, and the gradients of sum(y * gy) with respect to the input
    and every parameter, each within ``tol`` (the gradients within
    ``grad_tol`` when given: then the port's f32 gradients are also held to
    its own f64 run at 1e-5)."""
    grad_tol = grad_tol or tol
    from satpu_torch.models.convert import from_satpu_xvector

    v = satpu_init(jm, x, train=False, seed=seed)
    y0, new = jm.apply(v, x, train=True, mutable=["batch_stats"])
    gy = np.random.default_rng(seed + 100).standard_normal(np.shape(y0)).astype(np.float32)

    def f(params, x):
        y, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x, train=True,
                        mutable=["batch_stats"])
        return jnp.sum(y * gy)

    gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(v["params"], x)
    gp = from_satpu_xvector(jax_variables_numpy({"params": gp}))
    stats = from_satpu_xvector(jax_variables_numpy(new))
    pm = bridged(pm, v).train()
    xt = torch.from_numpy(_to_port(x)).requires_grad_(True)
    y = pm(xt)
    (y * torch.from_numpy(_to_port(gy))).sum().backward()
    assert y.shape == _to_port(y0).shape
    assert rel_err(y.detach().numpy(), _to_port(y0)) <= tol, "output"
    assert _close(xt.grad.numpy(), _to_port(gx), grad_tol), "input gradient"
    sd = pm.state_dict()
    assert stats and all(rel_err(sd[k].numpy(), v_.numpy()) <= tol for k, v_ in stats.items())
    named = dict(pm.named_parameters())
    assert set(named) == set(gp)
    for k, g in gp.items():
        assert _close(named[k].grad.numpy(), g.numpy(), grad_tol), k
    if grad_tol != tol:
        p64 = copy.deepcopy(bridged(pm, v)).double().train()
        x64 = torch.from_numpy(_to_port(x)).double().requires_grad_(True)
        (p64(x64) * torch.from_numpy(_to_port(gy)).double()).sum().backward()
        assert rel_err(xt.grad.numpy(), x64.grad.numpy()) <= 1e-5
        for k, p in p64.named_parameters():
            assert _close(named[k].grad.numpy(), p.grad.numpy(), 1e-5), k
    return pm


@pytest.mark.parametrize("shape", [(8, 51, 6), (4, 9, 13, 6)], ids=["1d", "2d"])
def test_batch_norm_training_mode(shape):
    """satpu's rule: f32, the biased batch variance over every axis but the
    channel's, running statistics moved by 0.1 towards the mean and the
    unbiased variance."""
    from satpu.models.torchlayers import BatchNorm as J
    from satpu_torch.sidekit.nn import BatchNorm as P

    x = (np.random.default_rng(1).standard_normal(shape) * 2 + 0.5).astype(np.float32)
    _train_mode(J(6), P(6), x)


def test_batch_norm_bf16_input_is_f32():
    from satpu_torch.sidekit.nn import BatchNorm

    y = BatchNorm(4).train()(torch.randn(3, 4, 5).bfloat16())
    assert y.dtype == torch.float32


@pytest.mark.parametrize("name", ["PreEcapaTDNN", "PreHalfResNet34"])
def test_trunk_training_mode(name):
    """The trunks on [8, 51, 24] features (8000 samples' frames: every 3x3
    stage of the half-ResNet sees at least 7 frames); the half-ResNet at
    depth (1, 2, 1, 1). The half-ResNet's train-mode backward is
    ill-conditioned in satpu's f32: its gradients depart from the port's
    f64 by up to 4.7e-3 (the port's f32 by 5.6e-7), so they are held at
    1e-2 and the port's f32 gradients to its f64 at 1e-5."""
    from satpu.sidekit import archi as J
    from satpu_torch.sidekit import archi as P

    jm, pm = {"PreEcapaTDNN": (J.PreEcapaTDNN(24, 32), P.PreEcapaTDNN(24, 32)),
              "PreHalfResNet34": (J.PreHalfResNet34((1, 2, 1, 1)),
                                  P.PreHalfResNet34((1, 2, 1, 1)))}[name]
    x = np.random.default_rng(5).standard_normal((8, 51, 24)).astype(np.float32)
    _train_mode(jm, pm, x, seed=5, grad_tol=1e-2 if name == "PreHalfResNet34" else None)


@pytest.mark.parametrize("global_context", [False, True], ids=["local", "global"])
def test_attentive_pooling_training_mode(global_context):
    """Its attention.2 batch norm on batch statistics; the [B, C, F, T]
    input flattens as C*F."""
    from satpu.sidekit.pooling import AttentivePooling as J
    from satpu_torch.sidekit.pooling import AttentivePooling as P

    x = np.random.default_rng(4).standard_normal((4, 3, 17, 8)).astype(np.float32)
    _train_mode(J(8, 3, global_context=global_context), P(8, 3, global_context=global_context),
                x, seed=4)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_gru_pooling(train):
    """GruPooling through the bridged torch GRU (two layers)."""
    from satpu.sidekit.pooling import GruPooling as J
    from satpu_torch.sidekit.pooling import GruPooling as P

    x = np.random.default_rng(7).standard_normal((4, 11, 6)).astype(np.float32)
    jm, pm = J(6, 5, 2), P(6, 5, 2)
    if train:
        _train_mode(jm, pm, x, seed=7)
        return
    v = satpu_init(jm, x, train=False, seed=7)
    ref = np.asarray(jm.apply(v, x, train=False))
    with torch.no_grad():
        out = bridged(pm, v)(torch.from_numpy(_to_port(x))).numpy()
    assert out.shape == ref.shape == (4, 5)
    assert rel_err(out, ref) <= 1e-4


def test_channelwise_corr_pooling():
    """Without dropout (satpu draws its channel mask from jax.random): rel
    1e-4, and the input gradient; with dropout, the channel mask comes from
    the generator and changes from call to call."""
    from satpu.sidekit.pooling import ChannelWiseCorrPooling as J
    from satpu_torch.models.convert import from_satpu_xvector
    from satpu_torch.sidekit.pooling import ChannelWiseCorrPooling as P

    kw = dict(in_channels=8, out_channels=5, in_freqs=4, merge_freqs_count=2)
    x = np.random.default_rng(8).standard_normal((3, 9, 4, 8)).astype(np.float32)  # [B,T,F,C]
    jm = J(channels_dropout=0.0, **kw)
    v = jax_variables_numpy(jm.init(jax.random.PRNGKey(0), x))
    ref = np.asarray(jm.apply(v, x))
    gy = np.random.default_rng(9).standard_normal(ref.shape).astype(np.float32)
    gx = np.asarray(jax.grad(lambda x: jnp.sum(jm.apply(v, x) * gy))(x))
    pm = P(channels_dropout=0.0, **kw)
    pm.load_state_dict(from_satpu_xvector(v))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 2, 1))).requires_grad_(True)
    out = pm.train()(xt)
    (out * torch.from_numpy(gy)).sum().backward()
    assert out.shape == ref.shape == (3, 2 * 10)
    assert rel_err(out.detach().numpy(), ref) <= 1e-4
    assert rel_err(xt.grad.numpy(), gx.transpose(0, 3, 2, 1)) <= 1e-4
    drop = P(channels_dropout=0.5, **kw).train()
    g = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(6):
        out = drop(torch.ones(2, 8, 4, 5), generator=g)
        assert torch.isfinite(out).all()
        seen.add(tuple(out.flatten().tolist()))
    assert len(seen) > 1  # the mask changes from call to call


HEADS = ["CCELoss", "ArcMarginProduct", "SoftmaxAngularProto", "CircleMargin",
         "AngularProximityMagnet", "CircleProto"]


def _heads():
    from satpu.sidekit import loss as J
    from satpu_torch.sidekit import loss as P

    return {"CCELoss": (J.CCELoss(16, 6), P.CCELoss(16, 6)),
            "ArcMarginProduct": (J.ArcMarginProduct(16, 6, s=30, m=0.2),
                                 P.ArcMarginProduct(16, 6, s=30, m=0.2)),
            "SoftmaxAngularProto": (J.SoftmaxAngularProto(6, 16), P.SoftmaxAngularProto(6, 16)),
            "CircleMargin": (J.CircleMargin(16, 6, k=2), P.CircleMargin(16, 6, k=2)),
            "AngularProximityMagnet": (J.AngularProximityMagnet(6, 16),
                                       P.AngularProximityMagnet(6, 16)),
            "CircleProto": (J.CircleProto(16, 6), P.CircleProto(16, 6))}


@pytest.mark.parametrize("name", HEADS)
def test_loss_head(name):
    """loss and logits, and d loss / d (input, parameters), 1e-5 (rel for
    the logits and gradients, of the value for the loss); NaN without a
    target. Pairs: rows 2i and 2i + 1 are one speaker."""
    from satpu_torch.models.convert import from_satpu_xvector

    jm, pm = _heads()[name]
    r = np.random.default_rng(HEADS.index(name))
    x = r.standard_normal((8, 16)).astype(np.float32)
    tgt = np.repeat(r.permutation(6)[:4], 2).astype(np.int32)
    v = jax_variables_numpy(jm.init(jax.random.PRNGKey(3), x, tgt))

    def f(params, x):
        loss, logits = jm.apply({"params": params}, x, tgt)
        return loss, logits

    (ref_loss, ref_logits), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        v["params"], x)
    gp = from_satpu_xvector(jax_variables_numpy({"params": gp}))
    sd = from_satpu_xvector(v)
    assert set(sd) == set(pm.state_dict())
    pm.load_state_dict(sd)
    xt = torch.from_numpy(x).requires_grad_(True)
    loss, logits = pm(xt, torch.from_numpy(tgt))
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * max(abs(float(ref_loss)), 1.0)
    assert rel_err(logits.detach().numpy(), ref_logits) <= 1e-5
    assert rel_err(xt.grad.numpy(), gx) <= 1e-5
    for k, p in pm.named_parameters():  # a shared logit bias has a zero gradient
        g = p.grad if p.grad is not None else torch.zeros_like(p)  # a head the loss skips
        assert _close(g.numpy(), gp[k].numpy(), 1e-5), k
    with torch.no_grad():
        nan_loss, logits = pm(xt)
    assert np.isnan(nan_loss.item()) and np.isnan(float(jm.apply(v, x)[0]))
    assert rel_err(logits.numpy(), np.asarray(jm.apply(v, x)[1])) <= 1e-5


@pytest.mark.parametrize("shape", [(5, 40, 24), (3, 12, 7)], ids=["wide", "narrow"])
def test_spec_masks_match_satpu(shape):
    """satpu's spec_masking draws (the same jax.random split and randint
    calls), applied by the port on [B, F, T]: the same zeros, exactly. The
    narrow case has masks wider than the features' room (start bound 1)."""
    from satpu.sidekit.preprocessor import spec_masking
    from satpu_torch.sidekit.preprocessor import apply_spec_masks

    B, T, F = shape
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        ref = np.asarray(spec_masking(x, key))
        kt, kf, kt2, kf2 = jax.random.split(key, 4)
        f_len = jax.random.randint(kf, (B,), 0, 11)
        f_start = jax.random.randint(kf2, (B,), 0, jnp.maximum(F - f_len, 1))
        t_len = jax.random.randint(kt, (B,), 0, 6)
        t_start = jax.random.randint(kt2, (B,), 0, jnp.maximum(T - t_len, 1))
        masks = tuple(torch.from_numpy(np.asarray(m).astype(np.int64))
                      for m in (f_len, f_start, t_len, t_start))
        out = apply_spec_masks(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))),
                               masks).numpy()
        np.testing.assert_array_equal(out, ref.transpose(0, 2, 1))


def test_spec_mask_draws_in_satpus_ranges():
    """draw_spec_masks: f_len in [0, 10], t_len in [0, 5], starts in
    [0, max(dim - len, 1)); every value taken; the same generator seed gives
    the same masks."""
    from satpu_torch.sidekit.preprocessor import draw_spec_masks

    g = torch.Generator().manual_seed(0)
    f_len, f_start, t_len, t_start = draw_spec_masks(4000, 30, 12, g)
    assert set(f_len.tolist()) == set(range(11)) and set(t_len.tolist()) == set(range(6))
    assert (f_start >= 0).all() and (f_start < torch.clamp(12 - f_len, min=1)).all()
    assert (t_start >= 0).all() and (t_start < torch.clamp(30 - t_len, min=1)).all()
    assert f_start.max() == 11 and t_start.max() == 29
    again = draw_spec_masks(4000, 30, 12, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip((f_len, f_start, t_len, t_start), again))


def test_bf16_policy_casts_conv_and_linear_only():
    """Inside autocast(bf16) every sidekit conv and linear runs in bf16 (the
    pooling convs and the embedding linear too, as satpu's torchlayers
    policy), batch norm returns f32, the ArcMargin head stays f32; outside
    it nothing is cast."""
    from satpu_torch.sidekit.nn import Conv1d, Linear, autocast
    from satpu_torch.sidekit.xvector import XVectorConfig, build_xvector

    from torch_parity import XV_TINY

    model = build_xvector(XVectorConfig(**XV_TINY)).train()
    seen = {}

    def hook(module, inputs, output):
        out = output[1] if isinstance(output, tuple) else output  # the head's logits
        seen[id(module)] = (type(module), out.dtype)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if type(m).__name__ in ("Conv1d", "Linear", "BatchNorm", "ArcMarginProduct")]
    wav = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 8000)).astype(np.float32))
    with autocast(torch.bfloat16):
        (loss, logits), xv = model(wav, torch.tensor([0, 1]))
    for h in hooks:
        h.remove()
    kinds = {}
    for cls, dtype in seen.values():
        kinds.setdefault(cls.__name__, set()).add(dtype)
    assert kinds["Conv1d"] == {torch.bfloat16} and kinds["Linear"] == {torch.bfloat16}
    assert kinds["BatchNorm"] == {torch.float32}
    assert logits.dtype == loss.dtype == xv.dtype == torch.float32
    assert model.stat_pooling.linear1.weight.dtype == torch.float32  # master weights
    with torch.no_grad():
        y = Conv1d(4, 4, 1)(torch.randn(1, 4, 3))
        z = Linear(4, 2)(torch.randn(1, 4))
    assert y.dtype == z.dtype == torch.float32
