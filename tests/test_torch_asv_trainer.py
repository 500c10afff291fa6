"""satpu_torch's ASV train step (``sidekit.trainer.AsvTrainer``) against
satpu's (``init_asv_state`` + ``make_asv_train_step``) on the CPU: a tiny
ECAPA (32 channels, 16-d embedding, 4 speakers), B=8 x 8000 samples,
SpecAugment off, from satpu's initial weights carried across by the bridge.

The train-mode trunk's backward is ill-conditioned with respect to its input
features: the port's log-mel features differ from satpu's by 3.9e-5 at most
here, and that moves the first two ECAPA layers' gradients by up to 11%
(fed satpu's features, the port's f64 gradients agree with satpu's to
2.4e-5, and the port's f32 with its f64 to 1.8e-5). So the step's parity is
held on satpu's features (the frontend is held on its own in
``test_torch_sidekit.py``), and the end-to-end run from wav to its losses.

- 3 steps at f32 with a one-cycle schedule (lr 5e-3 over 10 steps): loss
  rel 1e-4 (1.5e-5 measured at step 3), accuracy equal, every parameter
  and batch-norm statistic rel 1e-4; the zero-gradient tensor (the
  attention's last bias, under a softmax over time) only moves by at most
  lr a step, as Adam moves noise;
- from wav, the port's own frontend: losses rel 5e-4 (1.1e-4 measured);
- the AdamW groups against satpu's ``test_asv_optimizer_recipe_parity``
  scenario (head decay 50, trunk 0, one-cycle lr): the parameters after 3
  steps, rel 1e-4;
- bf16 (satpu's policy) to satpu's own rule: the first-step loss within 5%
  of f32, and the loss still falls;
- satpu's ``steps_per_epoch`` quirk, pinned."""
import jax
import numpy as np
import pytest
import torch

from torch_parity import jax_variables_numpy, rel_err

B, T, STEPS, LR = 8, 8000, 3, 5e-3
XV = dict(num_speakers=4, channels=32, embedding_size=16, spec_augment=False)
ZERO_GRAD_TENSORS = {"stat_pooling.linear2.bias"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(n=B, seed=0):
    rng = np.random.default_rng(seed)
    wav = (rng.standard_normal((n, T)) * 0.1).astype(np.float32)
    return wav, (np.arange(n) % 4).astype(np.int32)


def _satpu(wav, target, steps, optimizer=None, schedule=None, dtype="float32"):
    """satpu's state before and after ``steps`` steps: (initial variables,
    [(loss, accuracy)], final variables), numpy."""
    from satpu.sidekit.trainer import init_asv_state, make_asv_optimizer, make_asv_train_step
    from satpu.sidekit.xvector import XVectorConfig, build_xvector

    model = build_xvector(XVectorConfig(**XV))
    optimizer = optimizer or make_asv_optimizer(lr=LR)
    state = init_asv_state(model, jax.random.PRNGKey(0), wav, optimizer)
    v0 = jax_variables_numpy({"params": state.params, "batch_stats": state.batch_stats})
    step = jax.jit(make_asv_train_step(model, optimizer, lr_schedule=schedule,
                                       compute_dtype=dtype))
    metrics = []
    for i in range(steps):
        state, m = step(state, wav, target, jax.random.PRNGKey(i))
        metrics.append((float(m["loss"]), float(m["accuracy"])))
    return v0, metrics, jax_variables_numpy({"params": state.params,
                                             "batch_stats": state.batch_stats})


def _port(v0, wav, target, steps, schedule=None, feats=None, dtype="float32", **opt):
    """The port's trainer from satpu's initial variables: ([(loss,
    accuracy)], model); ``feats`` replaces its frontend."""
    from satpu_torch.models.convert import from_satpu_xvector
    from satpu_torch.sidekit.trainer import AsvTrainer, make_asv_optimizer
    from satpu_torch.sidekit.xvector import XVectorConfig, build_xvector

    model = build_xvector(XVectorConfig(**XV))
    model.load_state_dict(from_satpu_xvector(v0))
    if feats is not None:
        model.features = lambda w, generator=None: torch.from_numpy(feats)
    trainer = AsvTrainer(model, make_asv_optimizer(model, **({"lr": LR} | opt)),
                         lr_schedule=schedule, compute_dtype=dtype)
    metrics = []
    for _ in range(steps):
        m = trainer.train_step(torch.from_numpy(wav), torch.from_numpy(target).long())
        metrics.append((float(m["loss"]), float(m["accuracy"])))
    assert trainer.step == steps
    return metrics, model


def _satpu_features(wav):
    from satpu.sidekit.preprocessor import mel_spec_frontend

    return np.ascontiguousarray(np.asarray(mel_spec_frontend(wav, n_mels=80)).transpose(0, 2, 1))


@pytest.fixture(scope="module")
def three_steps():
    from satpu.utils.schedules import one_cycle as jcycle

    wav, target = _batch()
    return wav, target, _satpu(wav, target, STEPS, schedule=jcycle(LR, 10))


def test_three_steps_match_satpu(three_steps):
    from satpu_torch.models.convert import from_satpu_xvector
    from satpu_torch.utils.schedules import one_cycle

    wav, target, (v0, ref, v3) = three_steps
    out, model = _port(v0, wav, target, STEPS, one_cycle(LR, 10), feats=_satpu_features(wav))
    for (loss, acc), (jloss, jacc) in zip(out, ref):
        assert abs(loss - jloss) <= 1e-4 * abs(jloss), (loss, jloss)
        assert acc == jacc
    assert ref[-1][0] < ref[0][0]  # it trains
    want, start = from_satpu_xvector(v3), from_satpu_xvector(v0)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        if k in ZERO_GRAD_TENSORS:  # Adam moves noise by up to lr a step
            lim = STEPS * LR * (1 + 1e-3)
            assert (got[k] - start[k]).abs().max() <= lim and (w - start[k]).abs().max() <= lim
        else:
            assert rel_err(got[k].numpy(), w.numpy()) <= 1e-4, k
    assert any("running_var" in k for k in want)


def test_three_steps_from_wav(three_steps):
    """The port's own frontend: the losses follow satpu's to 5e-4."""
    from satpu_torch.utils.schedules import one_cycle

    wav, target, (v0, ref, _) = three_steps
    out, _ = _port(v0, wav, target, STEPS, one_cycle(LR, 10))
    for (loss, _), (jloss, _) in zip(out, ref):
        assert abs(loss - jloss) <= 5e-4 * abs(jloss), (loss, jloss)


def test_optimizer_groups_and_recipe_parity():
    """Two groups: the head at head_weight_decay, every other parameter (BN
    affines and biases too) at weight_decay; satpu's recipe scenario (lr
    1e-2 replaced by one_cycle(1e-3, 10), trunk decay 0, head 50) for 3
    steps: the head shrinks hard, the trunk barely, and every parameter
    matches satpu's at 1e-4."""
    from satpu.sidekit.trainer import make_asv_optimizer as jopt
    from satpu.utils.schedules import one_cycle as jcycle
    from satpu_torch.models.convert import from_satpu_xvector
    from satpu_torch.sidekit.trainer import make_asv_optimizer
    from satpu_torch.sidekit.xvector import XVectorConfig, build_xvector
    from satpu_torch.utils.schedules import one_cycle

    model = build_xvector(XVectorConfig(**XV))
    opt = make_asv_optimizer(model, lr=1e-3, weight_decay=2e-5, head_weight_decay=2e-4)
    trunk, head = opt.param_groups
    names = {id(p): n for n, p in model.named_parameters()}
    assert [names[id(p)] for p in head["params"]] == ["after_speaker_embedding.weight"]
    assert (trunk["weight_decay"], head["weight_decay"]) == (2e-5, 2e-4)
    assert len(trunk["params"]) + 1 == len(list(model.parameters()))
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8

    wav, target = _batch(4)
    v0, _, v3 = _satpu(wav, target, STEPS, jopt(lr=1e-2, weight_decay=0.0,
                                                head_weight_decay=50.0), jcycle(1e-3, 10))
    _, model = _port(v0, wav, target, STEPS, one_cycle(1e-3, 10), feats=_satpu_features(wav),
                     lr=1e-2, weight_decay=0.0, head_weight_decay=50.0)
    want, start, got = from_satpu_xvector(v3), from_satpu_xvector(v0), model.state_dict()
    head0 = start["after_speaker_embedding.weight"].norm()
    assert got["after_speaker_embedding.weight"].norm() < 0.97 * head0
    lin = "before_speaker_embedding_lin.weight"
    assert got[lin].norm() > 0.9 * start[lin].norm()
    for k, w in want.items():
        if k in ZERO_GRAD_TENSORS:
            continue
        assert rel_err(got[k].numpy(), w.numpy()) <= 1e-4, k


def test_bf16_policy_tracks_f32():
    """satpu's rule (tests/test_trainers.py::test_asv_bf16_policy_tracks_f32)
    on the port, constant lr, 8 steps: the first-step loss within 5% of f32
    (and of satpu's bf16), finite, falling, and both runs collapse the toy
    loss below 5% of its start."""
    wav, target = _batch(seed=1)
    v0, ref_bf16, _ = _satpu(wav, target, 1, dtype="bfloat16")
    f32, _ = _port(v0, wav, target, 8)
    bf16, _ = _port(v0, wav, target, 8, dtype="bfloat16")
    f32, bf16 = [m[0] for m in f32], [m[0] for m in bf16]
    assert np.isfinite(bf16).all()
    assert abs(bf16[0] - f32[0]) / abs(f32[0]) < 0.05, (f32[0], bf16[0])
    assert abs(bf16[0] - ref_bf16[0][0]) / abs(ref_bf16[0][0]) < 0.05
    assert min(bf16[1:]) < bf16[0], bf16
    assert bf16[-1] < 0.05 * bf16[0] and f32[-1] < 0.05 * f32[0], (f32, bf16)


def test_compute_dtype_is_checked():
    from satpu_torch.sidekit.trainer import AsvTrainer

    with pytest.raises(ValueError, match="compute_dtype"):
        AsvTrainer(torch.nn.Linear(1, 1), None, compute_dtype="float16")


def test_steps_per_epoch_quirk():
    """satpu's train_asv sizes the schedule's epoch as speakers x
    samples_per_speaker / minibatch_size (satpu/bin/train_asv.py:109-110);
    SideSampler yields examples_per_speaker times more. With ecapa.ini over
    VoxCeleb2 dev's 5994 speakers: 409 schedule steps an epoch, 26,223
    batches, so the one-cycle schedule ends 1/64 of the way through. The port
    keeps the formula."""
    import os

    from satpu_torch.bin.train_asv import TrainAsvOpts, lr_schedule, steps_per_epoch
    from satpu_torch.sidekit.dataset import SideSampler
    from satpu_torch.utils import config as cfg

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    opts = TrainAsvOpts()
    opts.load_from_config(cfg.load_ini(os.path.join(
        root, "egs/asv/voxceleb/configs/ecapa.ini"))["train"])
    assert (opts.minibatch_size, opts.examples_per_speaker, opts.samples_per_speaker,
            opts.epochs) == (1024, 64, 70, 25)
    spe = steps_per_epoch(5994, opts)
    assert spe == 409
    batches = SideSampler(np.arange(5994), 5994, opts.examples_per_speaker,
                          opts.samples_per_speaker, opts.minibatch_size).__len__() // 1024
    assert batches == 26223 and batches // spe == 64
    sched = lr_schedule(opts, spe)
    assert sched(spe * opts.epochs) == pytest.approx(opts.lr / 4 / 1e4)  # the cycle's end
    assert sched(batches) < sched(0)  # by the end of epoch 0 the lr has annealed away
    opts.lr_schedule = "exponential"
    sched = lr_schedule(opts, spe)
    assert sched(batches - 1) == pytest.approx(opts.lr * opts.lr_gamma ** 64)
    opts.lr_schedule = "constant"
    assert lr_schedule(opts, spe) is None
