"""The port's data-parallel training steps on the CPU: two and four gloo
ranks, each on its contiguous block of the global batches
(``torch_dp_worker``), against one process on the global batches, and
against satpu's single-device step (which its ``data``-mesh step equals) on
the same global batches. satpu's step and the one-process run are computed
once a module (fixtures); each world size is a case of the same test.

- the chain trainer (TDNN-F + VQ, NG on, dropout 0) in f64, 2 steps: the
  losses and metrics rel 1e-6 and the step-1 gradients after NG rel 1e-5
  per tensor (the objective runs in f32 on both sides: 7e-8 and 1.2e-6
  measured); every tensor after 2 steps rel 1e-5, but the zero-gradient
  biases (a bias feeding a non-affine batch norm), which Adam moves by
  rounding noise, within lr a step; the step-1 gradients against satpu's
  at ``test_torch_chain_trainer.py``'s 1e-3 (loss 1e-4);
- the ASV trainer (a tiny ECAPA, SpecAugment on) in f64, 3 steps: losses
  rel 1e-9, every tensor rel 1e-9 but the attention's zero-gradient bias;
  in f32 from satpu's init on satpu's features (SpecAugment off), against
  satpu's 3 steps at ``test_torch_asv_trainer.py``'s 1e-4;
- the GAN trainer (tiny generator and discriminators) in f64, 2 steps:
  metrics and every tensor rel 1e-9; in f32 from satpu's init, the step-1
  metrics against satpu's at ``test_torch_gan_trainer.py``'s 1e-4.

The ranks' blocks of each global batch differ (other content, unequal
``num_frames``): each test computes, from the data, what training each
block on its own statistics and averaging gives, and asserts that it
misses the global step by far more than the tolerance. Dropout is 0 in the
chain net: a rank draws its block of the global batch's masks, so a
data-parallel run draws the one-process run's values, but not satpu's
(another generator)."""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dp_worker as W
from torch_parity import ASRBN_TINY, jax_variables_numpy, rel_err

TIMEOUT = 150


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WORLDS = [2, 4]


def _spawn(case, runs, tmp_path, world):
    torch.save(runs, os.path.join(str(tmp_path), "inputs.pt"))
    outs = W.spawn(case, world, str(tmp_path), timeout=TIMEOUT)
    # every rank ends in rank 0's state
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            for k in a["state"]:
                assert torch.equal(a["state"][k], b["state"][k]), k
    return outs[0]


def _zero_grad(g, top):
    return g.abs().max().item() <= 1e-6 * top


# ---- chain --------------------------------------------------------------------------

P, N_SAMPLES, B = 40, 16000, 4


def _chain_batches():
    from satpu_torch.chain.fst import fst_rmepsilon, fst_to_arrays, pad_graph_arrays
    from satpu_torch.chain.prep import numerator_fst, random_bigram_den, random_phone_walk

    _, tree, trans = random_bigram_den(5, 3, seed=2)
    rng = np.random.default_rng(7)
    out = []
    for k in range(2):
        # halves of other loudness and unequal frame counts (32 frames of 1 s)
        frames = np.asarray([32, 25, 30, 20] if k == 0 else [20, 30, 31, 32], np.int32)
        graphs = pad_graph_arrays([fst_to_arrays(fst_rmepsilon(numerator_fst(
            random_phone_walk(trans, 9, rng), tree))) for _ in range(B)])
        wav = rng.standard_normal((B, N_SAMPLES)) * np.array([0.05, 0.1, 0.3, 0.5])[:, None]
        out.append((wav, graphs, frames))
    return out


def _warm_codebook(state, cfg, wav):
    """satpu's state with a warm VQ, as ``test_torch_asr_variant_trainer.py``
    warms it: the codebook is 8 frames of the bottleneck features of
    ``wav``, each with an EMA cluster size of 50 (from the random init the
    codebook collapses at its first update, and every gradient upstream of
    it is rounding noise that Adam turns into full-size updates)."""
    from satpu_torch.models.asrbn import TDNNFNet, TDNNFNetConfig
    from satpu_torch.models.convert import from_satpu_variables

    net = TDNNFNet(TDNNFNetConfig(**cfg)).double()
    net.load_state_dict(from_satpu_variables(jax_variables_numpy(
        {"params": state.params, "batch_stats": state.batch_stats,
         "vq_stats": state.vq_stats})))
    seen = []
    vq = net.tdnnfs[-1].tdnn.bottleneck_func.vq
    hook = vq.register_forward_pre_hook(lambda m, inp: seen.append(inp[0].detach()))
    with torch.no_grad():
        net.train()(torch.from_numpy(wav))
    hook.remove()
    feats = seen[0].transpose(1, 2).reshape(-1, seen[0].shape[1]).numpy()
    K = vq.num_embeddings
    emb = feats[np.linspace(0, len(feats) - 1, K).astype(int)].astype(np.float32)
    return state.replace(vq_stats={"vq_bottleneck": {"vq": {
        "embedding": jnp.asarray(emb), "ema_cluster_size": jnp.full((K,), 50.0),
        "ema_w": jnp.asarray(emb * 50.0)}}})


@pytest.fixture(scope="module")
def chain_case():
    """The chain run's inputs (satpu's init with a warm codebook, in f64),
    the one-process run, and satpu's step-1 loss and gradients."""
    import optax

    from satpu.chain.fst import Fst as JFst
    from satpu.chain.ngsgd import unstack_ng_state
    from satpu.chain.objf import DenominatorGraph as JDen
    from satpu.chain.trainer import init_chain_state, make_chain_train_step
    from satpu.models.asrbn import TDNNFNet as JNet
    from satpu.models.asrbn import TDNNFNetConfig as JCfg
    from satpu_torch.chain.prep import random_bigram_den
    from satpu_torch.models.convert import from_satpu_variables, ng_states_from_satpu

    cfg = dict(ASRBN_TINY, output_dim=P, p_dropout=0.0, natural_gradient=True)
    jnet = JNet(JCfg(**cfg))
    state = init_chain_state(jnet, jax.random.PRNGKey(0), np.zeros((2, 8000), np.float32),
                             optax.scale(1e6))
    batches = _chain_batches()
    state = _warm_codebook(state, cfg, batches[0][0])
    sd = {k: v.double() for k, v in from_satpu_variables(jax_variables_numpy(
        {"params": state.params, "batch_stats": state.batch_stats,
         "vq_stats": state.vq_stats})).items()}
    ng = ng_states_from_satpu(jax_variables_numpy(unstack_ng_state(state.ng_state)))
    run = {"dtype": torch.float64, "cfg": cfg, "state": sd, "ng_states": ng, "batches": batches}

    # satpu's step on the global batch
    fst = random_bigram_den(5, 3, seed=2)[0]
    jden = JDen.from_fst(JFst.from_text(fst.to_text()), P)
    wav, graphs, frames = batches[0]
    with jax.enable_x64():
        f64 = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating)
            else a, state)
        new, metrics = jax.jit(make_chain_train_step(jnet, jden, optax.scale(1e6)))(
            f64, wav, {k: jnp.asarray(v) for k, v in graphs.items()}, jnp.asarray(frames),
            jax.random.PRNGKey(0))
        ref = from_satpu_variables({"params": jax_variables_numpy(jax.tree_util.tree_map(
            lambda a, b: (np.asarray(a) - np.asarray(b)) / 1e6, new.params, f64.params))})
    return {"run": run, "one": W.run_chain(run), "satpu_loss": float(metrics["loss"]),
            "satpu_grads": ref}


@pytest.mark.parametrize("world", WORLDS)
def test_chain_step_is_the_global_batch_step(chain_case, world, tmp_path):
    run, one = chain_case["run"], chain_case["one"]
    batches = run["batches"]
    dp = _spawn("chain", [run], tmp_path, world)[0]

    lr = 1e-3
    for k in range(2):
        assert rel_err(dp["loss"][k], one["loss"][k]) <= 1e-6
        for name, v in one["metrics"][k].items():
            assert rel_err(dp["metrics"][k][name], v) <= 1e-6, name
    top = max(g.abs().max().item() for g in one["grads"].values())
    zero = {n for n, g in one["grads"].items() if _zero_grad(g, top)}
    assert zero and all(n.endswith(".bias") for n in zero)
    for n, g in one["grads"].items():
        if n in zero:
            assert _zero_grad(dp["grads"][n], top), n
        else:
            assert rel_err(dp["grads"][n].numpy(), g.numpy()) <= 1e-5, n
    for n, v in one["state"].items():
        if n in zero:
            assert (dp["state"][n] - v).abs().max().item() <= 2 * 2 * lr, n
        else:
            assert rel_err(dp["state"][n].numpy(), v.numpy()) <= 1e-5, n

    # satpu's step on the global batch
    assert rel_err(dp["loss"][0], chain_case["satpu_loss"]) <= 1e-4
    for n, g in dp["grads"].items():
        if n not in zero:
            assert rel_err(g.numpy(), chain_case["satpu_grads"][n].numpy()) <= 1e-3, n

    # per-rank statistics (each block trained alone, the gradients averaged)
    # miss the global step
    frames = batches[0][2]
    blocks = [W.run_chain(dict(run, batches=[tuple(W.block(x, r, world) for x in batches[0])]))
              for r in range(world)]
    assert len({int(W.block(frames, r, world).sum()) for r in range(world)}) > 1
    worst = max(rel_err(sum(b["grads"][n] for b in blocks).numpy() / world, g.numpy())
                for n, g in one["grads"].items() if n not in zero)
    assert worst > 1e-1


# ---- ASV ----------------------------------------------------------------------------

XV = dict(num_speakers=4, channels=32, embedding_size=16)
AB, AT, ASTEPS, ALR = 8, 8000, 3, 5e-3
ZERO_GRAD_TENSORS = {"stat_pooling.linear2.bias"}


def _asv_batch():
    rng = np.random.default_rng(0)
    scale = np.repeat([0.05, 0.3], AB // 2)[:, None]  # the halves differ in loudness
    wav = (rng.standard_normal((AB, AT)) * scale).astype(np.float32)
    return wav, (np.arange(AB) % 4).astype(np.int32)


@pytest.fixture(scope="module")
def asv_case():
    """The ASV runs' inputs (f64 with SpecAugment; f32 on satpu's features),
    the one-process f64 run, and satpu's 3 steps from the same init."""
    from satpu.sidekit.preprocessor import mel_spec_frontend
    from satpu.sidekit.trainer import init_asv_state, make_asv_optimizer, make_asv_train_step
    from satpu.sidekit.xvector import XVectorConfig as JCfg
    from satpu.sidekit.xvector import build_xvector as jbuild
    from satpu_torch.models.convert import from_satpu_xvector

    wav, spk = _asv_batch()
    jm = jbuild(JCfg(**XV, spec_augment=False))
    opt = make_asv_optimizer(lr=ALR)
    state = init_asv_state(jm, jax.random.PRNGKey(0), wav, opt)
    v0 = jax_variables_numpy({"params": state.params, "batch_stats": state.batch_stats})
    step = jax.jit(make_asv_train_step(jm, opt))
    jloss = []
    for i in range(ASTEPS):
        state, m = step(state, wav, spk, jax.random.PRNGKey(i))
        jloss.append(float(m["loss"]))
    v3 = from_satpu_xvector(jax_variables_numpy({"params": state.params,
                                                 "batch_stats": state.batch_stats}))
    feats = np.ascontiguousarray(np.asarray(mel_spec_frontend(wav, n_mels=80)).transpose(0, 2, 1))
    sd = from_satpu_xvector(v0)
    runs = [{"dtype": torch.float64, "cfg": dict(XV, spec_augment=True), "lr": ALR,
             "state": {k: v.double() for k, v in sd.items()},
             "batches": [(wav.astype(np.float64), spk)] * ASTEPS},
            {"dtype": torch.float32, "cfg": dict(XV, spec_augment=False), "lr": ALR,
             "state": sd, "batches": [(wav, spk)] * ASTEPS, "feats": [feats] * ASTEPS}]
    return {"runs": runs, "one": W.run_asv(runs[0]), "satpu_loss": jloss, "satpu_state": v3,
            "init": sd}


@pytest.mark.parametrize("world", WORLDS)
def test_asv_step_is_the_global_batch_step(asv_case, world, tmp_path):
    runs, one, sd = asv_case["runs"], asv_case["one"], asv_case["init"]
    wav, spk = runs[0]["batches"][0]
    dp64, dp32 = _spawn("asv", runs, tmp_path, world)
    for a, b in zip(dp64["loss"], one["loss"]):
        assert rel_err(a, b) <= 1e-9
    assert dp64["accuracy"] == one["accuracy"]
    for k, v in one["state"].items():
        if k in ZERO_GRAD_TENSORS:  # Adam moves noise by up to lr a step
            assert (dp64["state"][k] - v).abs().max() <= 2 * ASTEPS * ALR, k
        else:
            assert rel_err(dp64["state"][k].numpy(), v.numpy()) <= 1e-9, k
    assert any("running_var" in k for k in one["state"])

    # satpu's 3 steps on satpu's features
    for loss, ref in zip(dp32["loss"], asv_case["satpu_loss"]):
        assert rel_err(loss, ref) <= 1e-4
    for k, w in asv_case["satpu_state"].items():
        if k in ZERO_GRAD_TENSORS:
            lim = ASTEPS * ALR * (1 + 1e-3)
            assert (dp32["state"][k] - sd[k]).abs().max() <= lim, k
        else:
            assert rel_err(dp32["state"][k].numpy(), w.numpy()) <= 1e-4, k

    # per-rank batch statistics miss the global loss
    blocks = [W.run_asv(dict(runs[0], batches=[(W.block(wav, r, world), W.block(spk, r, world))]))
              for r in range(world)]
    per_rank = sum(b["loss"][0] for b in blocks) / world
    assert rel_err(per_rank, one["loss"][0]) > 1e-3


# ---- GAN ----------------------------------------------------------------------------

SHRINK = dict(mpd_periods=(2, 3), msd_scales=2, disc_channel_scale=1 / 16)
MEL = dict(n_fft=64, num_mels=8, hop_size=16, win_size=64, fmax=8000.0)
GB, T_BN, SEG = 4, 16, 16 * 16
NET = dict(output_dim=8, hidden_dim=16, bottleneck_dim=8, prefinal_bottleneck_dim=8)
GEN = dict(num_speakers=4, bn_dim=8, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
           upsample_initial_channel=32)


def _gan_batches():
    out = []
    for k in range(2):
        r = np.random.default_rng(10 + k)
        scale = np.repeat([0.05, 0.3], GB // 2)[:, None]
        out.append({"f0": (np.abs(r.standard_normal((GB, T_BN))) * 100).astype(np.float32),
                    "bn": r.standard_normal((GB, 8, T_BN)).astype(np.float32),
                    "spk": np.eye(4, dtype=np.float32)[[0, 1, 2, 3]],
                    "audio": (r.standard_normal((GB, SEG)) * scale).astype(np.float32)})
    return out


@pytest.fixture(scope="module")
def gan_case():
    """The GAN runs' inputs (satpu's init; f64 over two global batches, f32
    over one), the one-process f64 run, and satpu's step-1 metrics."""
    from satpu.hifigan.trainer import GanHparams, init_gan_state, make_gan_train_step
    from satpu.models.anonymizer import AnonymizationNet as JNet
    from satpu.models.anonymizer import AnonymizerConfig as JCfg
    from satpu.models.asrbn import TDNNFNetConfig as JTd
    from satpu_torch.models.anonymizer import AnonymizationNet, AnonymizerConfig
    from satpu_torch.models.asrbn import TDNNFNetConfig
    from satpu_torch.models.convert import from_satpu_discriminators, from_satpu_variables

    batches = _gan_batches()
    jmodel = JNet(JCfg(asrbn=JTd(**NET), **GEN))
    b0 = batches[0]
    variables = jmodel.init(jax.random.PRNGKey(0), b0["f0"], b0["bn"], b0["spk"],
                            method=jmodel.forward_decoder)
    h = GanHparams(segment_size=SEG, **MEL, **SHRINK)
    state, mpd, msd = init_gan_state(jmodel, dict(variables), jax.random.PRNGKey(0), h)
    init = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), {
        "g": state.params_g, "mpd": state.params_mpd, "msd": state.params_msd,
        "spectral": state.spectral_msd})
    _, jm = jax.jit(make_gan_train_step(jmodel, mpd, msd, h))(state, b0)

    cfg = dict(asrbn=TDNNFNetConfig(**NET), **GEN)
    sd = AnonymizationNet(AnonymizerConfig(**cfg)).state_dict()
    sd.update(from_satpu_variables({"params": init["g"]}))
    disc = {**{f"mpd.{k}": v for k, v in from_satpu_discriminators(
        {"params": init["mpd"], "spectral": {}}).items()},
        **{f"msd.{k}": v for k, v in from_satpu_discriminators(
            {"params": init["msd"], "spectral": init["spectral"]}).items()}}
    hp = dict(segment_size=SEG, **MEL, **SHRINK)
    f64 = {k: {n: v.double() if v.is_floating_point() else v for n, v in d.items()}
           for k, d in (("state", sd), ("disc", disc))}
    runs = [{"dtype": torch.float64, "cfg": cfg, "hparams": hp, **f64,
             "batches": [{k: v.astype(np.float64) for k, v in b.items()} for b in batches]},
            {"dtype": torch.float32, "cfg": cfg, "hparams": hp, "state": sd, "disc": disc,
             "batches": batches[:1]}]
    return {"runs": runs, "one": W.run_gan(runs[0]),
            "first": W.run_gan(dict(runs[0], batches=runs[0]["batches"][:1])),
            "satpu_metrics": {k: float(v) for k, v in jm.items()}}


@pytest.mark.parametrize("world", WORLDS)
def test_gan_step_is_the_global_batch_step(gan_case, world, tmp_path):
    runs, one = gan_case["runs"], gan_case["one"]
    dp64, dp32 = _spawn("gan", runs, tmp_path, world)
    for got, want in zip(dp64["metrics"], one["metrics"]):
        for k, v in want.items():
            assert rel_err(got[k], v) <= 1e-9, k
    for part in ("state", "disc"):
        for k, v in one[part].items():
            if v.is_floating_point():
                assert rel_err(dp64[part][k].numpy(), v.numpy()) <= 1e-9, (part, k)
    for k in ("loss_gen_all", "loss_disc_all", "mel_spec_error", "lr"):
        assert rel_err(dp32["metrics"][0][k], gan_case["satpu_metrics"][k]) <= 1e-4, k

    # a rank that stepped on its own block's gradients leaves the global step
    own = W.run_gan(dict(runs[0], batches=[W.block(runs[0]["batches"][0], 0, world)]))
    worst = max(rel_err(own["state"][k].numpy(), v.numpy())
                for k, v in gan_case["first"]["state"].items() if k.startswith("hifigan."))
    assert worst > 1e-3
