"""The port's GAN trainer against satpu's ``make_gan_train_step`` on satpu's
tiny setup (tests/test_gan_training.py ``_tiny_setup``) with two periods,
two scales (the spectral-normed one and an avg-pooled one) and 1/16 of the
discriminator widths, the same weights carried across by the bridge, f32
with TF32 off: step-1 gradients of G and D, the four metrics of steps 1-3,
the parameters, the spectral-norm state and the Adam moments after 3 steps,
an epoch-decayed lr; then the bf16 policy. satpu's jitted steps run once,
in a module fixture."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from torch_parity import rel_err

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SHRINK = dict(mpd_periods=(2, 3), msd_scales=2, disc_channel_scale=1 / 16)
MEL = dict(n_fft=64, num_mels=8, hop_size=16, win_size=64, fmax=8000.0)
B, T_BN, SEG = 2, 16, 16 * 16
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the tier-1 run shares the host's cores among its
    workers, and oversubscribed CPU convs slow down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(compute_dtype="float32"):
    from satpu.models.anonymizer import AnonymizerConfig as JCfg
    from satpu.models.asrbn import TDNNFNetConfig as JNet
    from satpu_torch.models.anonymizer import AnonymizerConfig
    from satpu_torch.models.asrbn import TDNNFNetConfig

    net = dict(output_dim=8, hidden_dim=16, bottleneck_dim=8, prefinal_bottleneck_dim=8)
    gen = dict(num_speakers=4, bn_dim=8, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
               upsample_initial_channel=32, compute_dtype=compute_dtype)
    return JCfg(asrbn=JNet(**net), **gen), AnonymizerConfig(asrbn=TDNNFNetConfig(**net), **gen)


def _batch():
    return {"f0": np.abs(np.random.default_rng(0).standard_normal((B, T_BN))
                         ).astype(np.float32) * 100,
            "bn": np.random.default_rng(1).standard_normal((B, 8, T_BN)).astype(np.float32),
            "spk": np.eye(4, dtype=np.float32)[[0, 1]],
            "audio": np.random.default_rng(2).standard_normal((B, SEG)).astype(np.float32) * 0.1}


def _np(tree):
    import jax

    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _adam(opt_state):
    """satpu's (mu, nu) trees of an inject_hyperparams(adamw) state."""
    inner = opt_state.inner_state[0]
    return _np(inner.mu), _np(inner.nu)


def _satpu_run(compute_dtype, steps, epoch_at=None):
    """satpu's tiny setup: its initial state (numpy) and, after each step,
    (metrics, state as numpy)."""
    import jax

    from satpu.hifigan.trainer import GanHparams, init_gan_state, make_gan_train_step
    from satpu.models.anonymizer import AnonymizationNet

    jcfg, _ = _cfgs(compute_dtype)
    model = AnonymizationNet(jcfg)
    batch = _batch()
    rng = jax.random.PRNGKey(0)
    # init in f32 so both policies share the same parameters
    f32 = AnonymizationNet(dataclasses.replace(jcfg, compute_dtype="float32"))
    variables = f32.init(rng, batch["f0"], batch["bn"], batch["spk"],
                         method=f32.forward_decoder)
    h = GanHparams(segment_size=SEG, compute_dtype=compute_dtype, **MEL, **SHRINK)
    state, mpd, msd = init_gan_state(model, dict(variables), rng, h)
    init = _np({"g": state.params_g, "mpd": state.params_mpd, "msd": state.params_msd,
                "spectral": state.spectral_msd})
    step = jax.jit(make_gan_train_step(model, mpd, msd, h))
    out = []
    for i in range(steps):
        if epoch_at is not None and i == epoch_at[0]:
            state = state.replace(epoch=state.epoch + epoch_at[1])
        state, metrics = step(state, batch)
        out.append(({k: float(v) for k, v in metrics.items()},
                    _np({"g": state.params_g, "mpd": state.params_mpd, "msd": state.params_msd,
                         "spectral": state.spectral_msd, "adam_g": _adam(state.opt_g),
                         "adam_d": _adam(state.opt_d)})))
    return init, out


@pytest.fixture(scope="module")
def satpu_f32():
    # 3 steps, then a 4th at epoch 3 (the lr decayed three times)
    return _satpu_run("float32", STEPS + 1, epoch_at=(STEPS, 3))


@pytest.fixture(scope="module")
def satpu_bf16():
    return _satpu_run("bfloat16", 1)


def _g_sd(tree):
    from satpu_torch.models.convert import from_satpu_variables

    return from_satpu_variables({"params": tree})


def _d_sd(params, spectral=None):
    from satpu_torch.models.convert import from_satpu_discriminators

    return from_satpu_discriminators({"params": params, "spectral": spectral or {}})


def _port_trainer(init, compute_dtype="float32"):
    from satpu_torch.hifigan.trainer import GanHparams, GanTrainer
    from satpu_torch.models.anonymizer import AnonymizationNet

    _, cfg = _cfgs(compute_dtype)
    model = AnonymizationNet(cfg)
    sd = model.state_dict()
    g = _g_sd(init["g"])
    assert set(g) == {k for k in sd if k.startswith("hifigan.")}
    model.load_state_dict({**sd, **g})
    trainer = GanTrainer(model, GanHparams(segment_size=SEG, compute_dtype=compute_dtype,
                                           **MEL, **SHRINK))
    trainer.mpd.load_state_dict(_d_sd(init["mpd"]))
    trainer.msd.load_state_dict(_d_sd(init["msd"], init["spectral"]))
    return trainer


def _torch_batch():
    return {k: torch.from_numpy(v) for k, v in _batch().items()}


def _named(trainer):
    """{"g": {name: param}, "mpd": ..., "msd": ...} of the port."""
    return {"g": dict((n, p) for n, p in trainer.model.named_parameters()
                      if n.startswith("hifigan.")),
            "mpd": dict(trainer.mpd.named_parameters()),
            "msd": dict(trainer.msd.named_parameters())}


def _satpu_named(tree, part):
    return _g_sd(tree) if part == "g" else _d_sd(tree)


def _run_port(init, steps, dtype=torch.float32):
    """The port's trainer from satpu's initial state, ``steps`` steps in
    ``dtype``: (trainer, metrics of each step, step-1 gradients by part)."""
    trainer = _port_trainer(init)
    for m in (trainer.model, trainer.mpd, trainer.msd):
        m.to(dtype)
    batch = {k: v.to(dtype) for k, v in _torch_batch().items()}
    metrics, grads = [], None
    for i in range(steps):
        metrics.append({k: float(v) for k, v in trainer.train_step(batch).items()})
        if i == 0:
            grads = {part: {n: p.grad.double().clone() for n, p in ps.items()}
                     for part, ps in _named(trainer).items()}
    return trainer, metrics, grads


@pytest.fixture(scope="module")
def port_f32(satpu_f32):
    return _run_port(satpu_f32[0], STEPS)


@pytest.fixture(scope="module")
def port_f64_grads(satpu_f32):
    return _run_port(satpu_f32[0], 1, torch.float64)[2]


def _satpu_grads(ref):
    """satpu's step-1 gradients by part: after one step its first moment is
    (1 - b1) * gradient."""
    (mu_g, _), (mu_d, _) = ref[0][1]["adam_g"], ref[0][1]["adam_d"]
    return {part: {n: v.double() / (1 - 0.8) for n, v in sd.items()}
            for part, sd in (("g", _g_sd(mu_g)), ("mpd", _d_sd(mu_d["mpd"])),
                             ("msd", _d_sd(mu_d["msd"])))}


def _worst(a, b):
    return max(rel_err(a[n].numpy(), b[n].numpy()) for n in a)


def test_generator_gradient_is_ill_conditioned_at_f32(satpu_f32, port_f32, port_f64_grads):
    """Shown, not a fault: the generator's step-1 gradient in f32 departs
    from the same computation in f64 by ~1e-4 of a tensor's largest entry on
    both sides (the weight-norm projection and the log of the generated
    audio's small mel bins amplify rounding), while the discriminators'
    agree to ~1e-6. satpu's generator cannot run in f64 (it casts its
    waveform to f32, satpu/models/hifigan.py:295), so the generator is held
    at 1e-3 below and the discriminators at 1e-4."""
    satpu = _satpu_grads(satpu_f32[1])
    port, port64 = port_f32[2], port_f64_grads
    g_port, g_satpu = _worst(port["g"], port64["g"]), _worst(satpu["g"], port64["g"])
    d_port = max(_worst(port[p], port64[p]) for p in ("mpd", "msd"))
    print(f"generator f32 vs f64: port {g_port:.3e}, satpu {g_satpu:.3e}; "
          f"discriminators port f32 vs f64 {d_port:.3e}")
    assert 1e-5 < g_port <= 1e-3 and 1e-5 < g_satpu <= 1e-3
    assert d_port <= 1e-5


def test_step1_gradients(satpu_f32, port_f32, port_f64_grads):
    want = _satpu_grads(satpu_f32[1])
    for part, got in port_f32[2].items():
        assert set(got) == set(want[part]), part
        tol = 1e-3 if part == "g" else 1e-4
        for name, g in got.items():
            assert rel_err(g.numpy(), want[part][name].numpy()) <= tol, name
            assert rel_err(port_f64_grads[part][name].numpy(), want[part][name].numpy()) <= tol


def test_metrics_steps_1_to_3(satpu_f32, port_f32):
    _, ref = satpu_f32
    _, metrics, _ = port_f32
    for i in range(STEPS):
        for k in ("loss_gen_all", "loss_disc_all", "mel_spec_error", "lr"):
            assert rel_err(metrics[i][k], ref[i][0][k]) <= 1e-4, (i, k)


# Adam turns an entry's relative gradient error into a parameter error of
# about lr x that error a step. The discriminators' gradients agree to
# rounding: an entry is held to 1e-6 unless its step-1 gradient is under
# D_EXEMPT_BELOW of its tensor's largest (one run: 3 entries of the MSD's
# spectral-normed convs, at most 2.1e-7 of the largest, moved by up to
# 2.4e-6; the (u, v) of such a conv moved by up to 4.2e-6). The generator's
# gradient is ill-conditioned (above): a tensor's step-1 gradients agree to
# eps of its largest entry (up to 3.1e-4, in conv_pre), so an entry whose
# gradient is r of the largest is held to lr x STEPS x eps / r, and to no
# less than 1e-6. A sign-flipped update (2 x lr a step) breaks that bound
# wherever r > eps. One run: 52 of 49,410 entries moved by more than 1e-6,
# each within 0.47 of its bound; 35 had r < eps (their sign is not fixed by
# two gradients that agree to eps).
D_EXEMPT_BELOW = 1e-6
LR = 2e-4


def test_state_after_3_steps(satpu_f32, port_f32):
    _, ref = satpu_f32
    trainer, _, grads = port_f32
    state = ref[STEPS - 1][1]
    mu_g, nu_g = state["adam_g"]
    mu_d, nu_d = state["adam_d"]
    moments = {"g": (_g_sd(mu_g), _g_sd(nu_g)),
               "mpd": (_d_sd(mu_d["mpd"]), _d_sd(nu_d["mpd"])),
               "msd": (_d_sd(mu_d["msd"]), _d_sd(nu_d["msd"]))}
    satpu_g = _satpu_grads(ref)["g"]
    n_g = n_above = n_unsigned = n_d_exempt = 0
    exempt_convs = set()
    for part, params in _named(trainer).items():
        want = _satpu_named(state["g"] if part == "g" else state[part], part)
        opt = trainer.opt_g if part == "g" else trainer.opt_d
        for name, p in params.items():
            diff = np.abs(p.detach().numpy() - want[name].numpy())
            if part == "g":
                g = satpu_g[name].numpy()
                eps = np.abs(grads["g"][name].numpy() - g).max() / np.abs(g).max()
                r = np.abs(g) / np.abs(g).max()
                bound = np.maximum(1e-6, LR * STEPS * eps / np.maximum(r, 1e-30))
                assert (diff <= bound).all(), (name, float((diff / bound).max()))
                n_g, n_above = n_g + r.size, n_above + int((diff > 1e-6).sum())
                n_unsigned += int((r < eps).sum())
            else:
                g = grads[part][name].abs().numpy()
                exempt = g < D_EXEMPT_BELOW * g.max()
                assert diff[~exempt].max(initial=0.0) <= 1e-6, name
                n_d_exempt += int((diff[exempt] > 1e-6).sum())
                if part == "msd" and (diff > 1e-6).any():
                    exempt_convs.add(name.rsplit(".", 1)[0])
            st, (mu, nu) = opt.state[p], (moments[part][0][name], moments[part][1][name])
            if part == "g":  # moments of O(100): held relative to the largest
                assert rel_err(st["exp_avg"].numpy(), mu.numpy()) <= 1e-3, name
                assert rel_err(st["exp_avg_sq"].numpy(), nu.numpy()) <= 1e-3, name
            else:
                assert np.abs(st["exp_avg"].numpy() - mu.numpy()).max() <= 1e-6, name
                assert np.abs(st["exp_avg_sq"].numpy() - nu.numpy()).max() <= 1e-6, name
    # the generator's looser bound reaches few entries, and few have no
    # sign fixed by the gradients; the discriminators' exemption, 3 entries
    assert n_above <= 2e-3 * n_g and n_unsigned <= 1e-3 * n_g, (n_above, n_unsigned, n_g)
    assert n_d_exempt <= 5, n_d_exempt
    sn = _d_sd({}, state["spectral"])
    msd_state = trainer.msd.state_dict()
    assert len(sn) == 16  # (u, v) of the 8 spectral-normed convs
    for key, val in sn.items():
        # a conv with exempt weight entries normalizes by a sigma they moved
        tol = 1e-5 if key.rsplit(".", 1)[0] in exempt_convs else 1e-6
        assert np.abs(msd_state[key].numpy() - val.numpy()).max() <= tol, key


def test_epoch_decayed_lr(satpu_f32, port_f32):
    """A 4th step at epoch 3: lr 2e-4 x 0.999^3 in the metrics and in the
    discriminators' update (the well-conditioned side)."""
    _, ref = satpu_f32
    trainer, _, grads = port_f32
    trainer.epoch += 3
    m = trainer.train_step(_torch_batch())
    want, state = ref[STEPS]
    assert rel_err(m["lr"], 2e-4 * 0.999 ** 3) <= 1e-6
    assert rel_err(m["lr"], want["lr"]) <= 1e-6
    for k in ("loss_gen_all", "loss_disc_all", "mel_spec_error"):
        assert rel_err(float(m[k]), want[k]) <= 1e-4, k
    named = _named(trainer)
    for part in ("mpd", "msd"):
        sd = _d_sd(state[part])
        for name, p in named[part].items():
            g = grads[part][name].abs().numpy()
            keep = g >= D_EXEMPT_BELOW * g.max()
            assert np.abs(p.detach().numpy() - sd[name].numpy())[keep].max() <= 1e-6, name


def test_bf16_policy_step1_matches_satpu(satpu_bf16):
    init, ref = satpu_bf16
    trainer = _port_trainer(init, "bfloat16")
    m = trainer.train_step(_torch_batch())
    for k in ("loss_gen_all", "loss_disc_all", "mel_spec_error"):
        assert rel_err(float(m[k]), ref[0][0][k]) <= 2e-2, k


def test_bf16_policy_tracks_f32(satpu_f32):
    """The port's own bf16 trajectory against its f32 one over 6 steps, with
    satpu's tolerances (tests/test_gan_training.py::test_gan_bf16_policy_tracks_f32)."""
    init, _ = satpu_f32
    hist = {}
    for dt in ("float32", "bfloat16"):
        trainer, batch = _port_trainer(init, dt), _torch_batch()
        hist[dt] = [{k: float(v) for k, v in trainer.train_step(batch).items()}
                    for _ in range(6)]
    for a, b in zip(hist["float32"], hist["bfloat16"]):
        assert np.isfinite(b["loss_gen_all"]) and np.isfinite(b["loss_disc_all"])
        assert abs(b["loss_gen_all"] - a["loss_gen_all"]) / max(abs(a["loss_gen_all"]), 1.0) < 0.15
        assert abs(b["loss_disc_all"] - a["loss_disc_all"]) / max(abs(a["loss_disc_all"]),
                                                                  1.0) < 0.25
    assert hist["bfloat16"][-1]["loss_disc_all"] < hist["bfloat16"][0]["loss_disc_all"]


def test_eval_and_sample_steps(satpu_f32):
    """The validation error against satpu's eval step on the initial
    weights; the sample step's mels give the same error."""
    import jax

    from satpu.hifigan.trainer import GanHparams as JH
    from satpu.hifigan.trainer import make_gan_eval_step
    from satpu.models.anonymizer import AnonymizationNet as JAnon

    init, _ = satpu_f32
    jcfg, _ = _cfgs()
    jmodel = JAnon(jcfg)
    step = jax.jit(make_gan_eval_step(jmodel, JH(segment_size=SEG, **MEL)))
    want = float(step({"hifigan": init["g"]["hifigan"]}, {"params": {}}, _batch()))
    trainer = _port_trainer(init)
    batch = _torch_batch()
    got = float(trainer.eval_step(batch))
    assert rel_err(got, want) <= 1e-5
    y_gen, mel_gen, mel_real = trainer.sample_step(batch)
    assert y_gen.shape == (B, SEG) and mel_gen.shape == mel_real.shape
    assert rel_err(float((mel_real - mel_gen).abs().mean()), got) <= 1e-6


def test_split_and_merge_generator_params():
    from satpu_torch.hifigan.trainer import merge_generator_params, split_generator_params

    sd = {"hifigan.conv_pre.bias": torch.zeros(2), "bn_extractor.tdnn1.bias": torch.ones(2)}
    train, frozen = split_generator_params(sd)
    assert list(train) == ["hifigan.conv_pre.bias"] and list(frozen) == ["bn_extractor.tdnn1.bias"]
    assert merge_generator_params(train, frozen) == sd


def test_checkpoint_state_round_trip(satpu_f32):
    """d_ and trainer_ state_dicts restore a trainer that steps on alike."""
    init, _ = satpu_f32
    a, b = _port_trainer(init), _port_trainer(init)
    batch = _torch_batch()
    a.train_step(batch)
    # copies, as a save and a load make (a loaded optimizer state would
    # share a's tensors, which a's next step changes in place)
    b.model.load_state_dict(copy.deepcopy(a.model.state_dict()))
    b.load_discriminator_state_dict(copy.deepcopy(a.discriminator_state_dict()))
    b.load_state_dict(copy.deepcopy(a.state_dict()))
    assert b.step == 1
    ma, mb = a.train_step(batch), b.train_step(batch)
    assert all(float(ma[k]) == float(mb[k]) for k in ma)
