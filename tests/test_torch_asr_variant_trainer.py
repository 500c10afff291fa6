"""The chain trainer on the ASR-BN variants against satpu on the CPU:
satpu's jitted step and the port's ``ChainTrainer`` from the same bridged
weights, statistics and NG states, on the same batches (a 5-phone den
graph of 40 pdfs, B=3 x 1 s, dropout 0, NG on, AdamW with the exponential
lr schedule of ``train_asr`` over 10 steps). Both networks run in f64
(satpu under ``jax.enable_x64``, where its wav2vec2 layer norms and
attention softmax still compute in f32, and its objective in f32 on both
sides), the train-mode batch norm being ill-conditioned at f32.

- the wav2vec2-VQ net (tiny wav2vec2 large-style front, TDNN-F 32, VQ-8,
  its codebook warm: see ``_warm_codebook``), 3 steps with satpu's
  ``preprocessor_schedule`` (the front takes 1/20 of its update at steps 0
  and 1, 1/5 at step 2): every step's metrics at rel 1e-5 (the f32
  objective), and every parameter after 3 steps within 1e-5 of its
  tensor's largest entry plus twice the lr summed over the steps, at most
  1% of the entries beyond 1e-5 of the largest plus 1e-2 x that sum (Adam
  turns a gradient entry under the f32 objective's rounding into a
  full-size update of either sign); the front's step-0 update at 1/20 of
  the update it takes without the schedule;
- the speaker-adversarial net (TDNN-F 32, half-ResNet branch over 3
  speakers) in its train_asi phase, ``freeze_encoder``'s filter, 4 steps
  (the orthonormal constraint after the 4th): the first step as above,
  steps 1-3 held to the port's own f32 conditioning (see the test), and
  the frozen trunk bit for bit at its initial values.

Then the bf16 training policy to satpu's rule
(``tests/test_trainers.py::test_chain_bf16_policy_tracks_f32``): 6 steps of
the fbank TDNN-F in bf16 and in f32, NG off and on, from the same init:
finite, the first objf within 5% + 0.02 of f32's, the objf rising. And the
wav2vec2 net's bf16 step: the front's convs and linears take bf16, its
layer norms f32, the master parameters f32, the objf within satpu's
5% + 0.02 of f32's.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import jax_variables_numpy, rel_err

P = 40  # pdfs of random_bigram_den(5, 3)
B, N_SAMPLES = 3, 16000
W2V = dict(conv_dim=(16, 16, 16), conv_kernel=(10, 8, 4), conv_stride=(5, 8, 8),
           hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
NET = dict(hidden_dim=32, bottleneck_dim=16, prefinal_bottleneck_dim=16, p_dropout=0.0,
           natural_gradient=True)
LR0, LR1, TOTAL = 1e-3, 1e-4, 10


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def chain_data():
    from satpu.chain.fst import Fst as JFst
    from satpu.chain.objf import DenominatorGraph as JDen
    from satpu_torch.chain.fst import fst_rmepsilon, fst_to_arrays, pad_graph_arrays
    from satpu_torch.chain.objf import DenominatorGraph
    from satpu_torch.chain.prep import numerator_fst, random_bigram_den, random_phone_walk

    fst, tree, trans = random_bigram_den(5, 3, seed=2)
    rng = np.random.default_rng(7)
    frames = np.full(B, ((N_SAMPLES + 80) // 160 - 2) // 3, np.int32)
    batches = []
    for _ in range(2):
        graphs = pad_graph_arrays([fst_to_arrays(fst_rmepsilon(numerator_fst(
            random_phone_walk(trans, 9, rng), tree))) for _ in range(B)])
        wav = (rng.standard_normal((B, N_SAMPLES)) * 0.1).astype(np.float32)
        batches.append((wav, graphs, frames))
    return {"batches": batches, "tden": DenominatorGraph.from_fst(fst, P),
            "jden": JDen.from_fst(JFst.from_text(fst.to_text()), P)}


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating)
        else a, tree)


def _lr(step):
    return LR0 * float(np.exp(min(step / TOTAL, 1.0) * np.log(LR1 / LR0)))


def _warm_codebook(state, port_net, wav):
    """satpu's state with a warm VQ: the codebook is 8 frames of the
    bottleneck features of ``wav`` in a train-mode forward (taken from the
    port's net with satpu's weights), each with an EMA cluster size of 50.
    From the random init the codebook collapses to one code at the first
    EMA update (in satpu and the port alike, ROADMAP "Recorded, not port
    faults"), and a batch norm then normalizes a constant: its ReLU gates
    rounding noise, and the gradients upstream of the VQ are noise (the
    port's own f32 and f64 ones differ by 100%)."""
    seen = []
    vq = port_net.tdnnfs[-1].tdnn.bottleneck_func.vq
    hook = vq.register_forward_pre_hook(lambda m, inp: seen.append(inp[0].detach()))
    with torch.no_grad():
        port_net.train()(torch.from_numpy(wav).to(next(port_net.parameters()).dtype))
    hook.remove()
    feats = seen[0].transpose(1, 2).reshape(-1, seen[0].shape[1]).double().numpy()
    K = vq.num_embeddings
    emb = feats[np.linspace(0, len(feats) - 1, K).astype(int)].astype(np.float32)
    vq_stats = {"vq_bottleneck": {"vq": {"embedding": jnp.asarray(emb),
                                         "ema_cluster_size": jnp.full((K,), 50.0),
                                         "ema_w": jnp.asarray(emb * 50.0)}}}
    return state.replace(vq_stats=vq_stats)


def _run_satpu(jnet, wav0, d, steps, spk=None, warm=None, **step_kw):
    """satpu's state (bridged) before, and its params and metrics after each
    of ``steps`` jitted steps in f64. ``warm(state) -> state`` adjusts the
    initial state."""
    from satpu.chain.ngsgd import unstack_ng_state
    from satpu.chain.trainer import ChainTrainOpts as JOpts
    from satpu.chain.trainer import (apply_orthonormal_constraint, init_chain_state,
                                     make_chain_optimizer, make_chain_train_step)

    opts = JOpts(lr=LR0)
    opt = make_chain_optimizer(opts)
    state = init_chain_state(jnet, jax.random.PRNGKey(0), wav0, opt)
    if warm is not None:
        state = warm(state)
    init = jax_variables_numpy({"params": state.params, "batch_stats": state.batch_stats,
                                "vq_stats": state.vq_stats})
    ng = jax_variables_numpy(unstack_ng_state(state.ng_state))
    out = []
    freeze = step_kw.get("freeze_filter")
    with jax.enable_x64():
        step = jax.jit(make_chain_train_step(
            jnet, d["jden"], opt, opts,
            lr_schedule=lambda s: LR0 * jnp.exp(jnp.minimum(s / TOTAL, 1.0)
                                                * np.log(LR1 / LR0)), **step_kw))
        state = _f64(state)
        for k in range(steps):
            wav, graphs, frames = d["batches"][k % 2]
            kw = {} if spk is None else {"spk_target": jnp.asarray(spk)}
            state, m = step(state, wav.astype(np.float64),
                            {kk: jnp.asarray(v) for kk, v in graphs.items()},
                            jnp.asarray(frames), jax.random.PRNGKey(k), **kw)
            if (k + 1) % 4 == 0:  # train_asr's orthonormal constraint
                new = apply_orthonormal_constraint(state.params)
                if freeze is not None:
                    new = jax.tree_util.tree_map_with_path(
                        lambda path, n, o: o if freeze(tuple(str(getattr(p, "key", p))
                                                             for p in path)) else n,
                        new, state.params)
                state = state.replace(params=new)
            out.append((jax_variables_numpy({"params": state.params}),
                        {kk: float(v) for kk, v in m.items()}))
    return init, ng, out


def _run_port(net, ng, d, steps, spk=None, **trainer_kw):
    from satpu_torch.chain.objf import graphs_to_torch
    from satpu_torch.chain.trainer import ChainTrainer, ChainTrainOpts
    from satpu_torch.models.convert import ng_states_from_satpu

    trainer = ChainTrainer(net, d["tden"], ChainTrainOpts(lr=LR0), lr_schedule=_lr,
                           ng_states=ng_states_from_satpu(ng), **trainer_kw)
    out = []
    for k in range(steps):
        wav, graphs, frames = d["batches"][k % 2]
        kw = {} if spk is None else {"spk_target": torch.from_numpy(spk).long()}
        m = trainer.step(torch.from_numpy(wav), graphs_to_torch(graphs, "cpu"),
                         torch.from_numpy(frames), **kw)
        out.append(({n: p.detach().clone() for n, p in net.named_parameters()},
                    {kk: float(v) for kk, v in m.items()}))
    return trainer, out


def _check_steps(sat, port, lrs, metric_tol):
    """Per step k, each metric at rel ``metric_tol[k]``; after the last,
    every parameter entry within 1e-5 of its tensor's largest plus twice the
    lr summed over the steps (an Adam update whose gradient entry lies
    under the f32 objective's rounding takes either sign at full size
    ``lr``), and at most 1% of the entries beyond 1e-5 of the largest plus
    1e-2 x that sum. ``lrs``: {parameter name: [the step's lr for it]}."""
    from satpu_torch.models.convert import from_satpu_variables

    for k, tol in enumerate(metric_tol):
        (_, jm), (_, pm) = sat[k], port[k]
        for name in ("loss", "chain_objf", *[n for n in jm if n.startswith(("vq_", "spkadv_"))]):
            assert rel_err(pm[name], jm[name]) <= tol, (k, name, pm[name], jm[name])
    ref = from_satpu_variables(sat[-1][0])
    got = port[-1][0]
    assert set(ref) == set(got)
    n_all = n_far = 0
    for n, v in got.items():
        r, lr_sum = ref[n].numpy(), sum(lrs(n))
        err = np.abs(v.numpy() - r)
        assert err.max() <= 1e-5 * np.abs(r).max() + 2 * lr_sum, (n, err.max(), lr_sum)
        n_far += int((err > 1e-5 * np.abs(r).max() + 1e-2 * lr_sum).sum())
        n_all += err.size
    assert n_far <= 0.01 * n_all, (n_far, n_all)


def test_wav2vec2_vq_steps_with_preprocessor_schedule_match_satpu(chain_data):
    from satpu.models.asrbn import Wav2Vec2TDNNFNet as JNet
    from satpu.models.asrbn import wav2vec2_tdnnf_config as jcfg
    from satpu.models.wav2vec2 import Wav2Vec2Config as JW
    from satpu_torch.models.asrbn import Wav2Vec2TDNNFNet, wav2vec2_tdnnf_config
    from satpu_torch.models.convert import from_satpu_variables
    from satpu_torch.models.wav2vec2 import Wav2Vec2Config

    def sched(step):
        frac = step / float(TOTAL)
        return 1.0 / 20.0 if frac < 0.1 else 1.0 / 5.0 if frac < 0.9 else 0.0

    def jsched(step):
        frac = step / float(TOTAL)
        return jnp.where(frac < 0.1, 1.0 / 20.0, jnp.where(frac < 0.9, 1.0 / 5.0, 0.0))

    net_kw = dict(NET, codebook_size=8)
    jnet = JNet(dataclasses.replace(jcfg(P, "vq", 8), **net_kw), JW(**W2V))
    d = chain_data

    def port_net(variables):
        net = Wav2Vec2TDNNFNet(dataclasses.replace(wav2vec2_tdnnf_config(P, "vq", 8), **net_kw),
                               Wav2Vec2Config(**W2V))
        net.load_state_dict(from_satpu_variables(variables))
        return net.double()

    def warm(state):
        return _warm_codebook(state, port_net(jax_variables_numpy(
            {"params": state.params, "batch_stats": state.batch_stats,
             "vq_stats": state.vq_stats})), d["batches"][0][0])

    init, ng, sat = _run_satpu(jnet, d["batches"][0][0][:2], d, 3, warm=warm,
                               preprocessor_schedule=jsched)
    port_net = functools.partial(port_net, init)

    net = port_net()
    trainer, port = _run_port(net, ng, d, 3, preprocessor_schedule=sched)
    assert trainer.group_kinds == ["main", "preprocessor"]
    _check_steps(sat, port, lambda n: [_lr(k) * (sched(k) if n.startswith("preprocessor.")
                                                 else 1.0) for k in range(3)],
                 [1e-5] * 3)
    # the schedule's factor at step 0: the front moved 1/20 of the update
    # that the same step takes without the schedule
    plain, _ = _run_port(port_net(), ng, d, 1)
    start = port_net().state_dict()
    after = port[0][0]
    moved = plain.model.state_dict()
    for n in ("preprocessor.encoder.layers.0.attention.q_proj.weight",
              "preprocessor.feature_extractor.conv_layers.0.conv.weight"):
        got, full = after[n] - start[n], moved[n] - start[n]
        assert rel_err((got * 20).numpy(), full.numpy()) <= 1e-9, n


def test_spkadv_steps_with_freeze_encoder_match_satpu(chain_data):
    """The speaker branch's half-ResNet trunk is ill-conditioned in train
    mode (ROADMAP "Recorded, not port faults": a ReLU input within rounding
    of zero takes either branch), and Adam turns a gradient entry under the
    rounding into a full-size update of either sign: after step 0 about
    0.6% of its first stage's conv weights differ by 2 lr between satpu and
    the port, and from step 1 on the branch's loss moves with them. So the
    first step is held as the others are (metrics at rel 1e-5, every
    parameter within the two-tier bound), and steps 1-3 against the port's
    own conditioning: the port in f64 departs from satpu by at most 10 times
    (and 1e-5 at least) as much as the port in f32 departs from the port in
    f64, in each metric and in the relative L2 distance over all
    parameters. The frozen trunk stays bit for bit at its initial values on
    both sides' terms, and the heads and the branch move."""
    from satpu.models.asrbn import TDNNFNetConfig as JCfg
    from satpu.models.spkadv import SpkAdvTDNNFNet as JNet
    from satpu_torch.bin.train_asr import TRAINABLE_HEADS
    from satpu_torch.models.asrbn import TDNNFNetConfig
    from satpu_torch.models.convert import from_satpu_variables
    from satpu_torch.models.spkadv import SpkAdvTDNNFNet

    spk = np.array([0, 2, 1], np.int32)

    def jfreeze(keys):
        return "acoustic" in keys and not any(k in TRAINABLE_HEADS for k in keys)

    def freeze(name):
        parts = name.split(".")
        return "acoustic" in parts and not TRAINABLE_HEADS & set(parts)

    jnet = JNet(JCfg(output_dim=P, **NET), num_speakers=3)
    d = chain_data
    steps = 4  # the 4th step is followed by the orthonormal constraint
    init, ng, sat = _run_satpu(jnet, d["batches"][0][0][:2], d, steps, spk=spk,
                               freeze_filter=jfreeze)

    def port_run(dtype, n):
        net = SpkAdvTDNNFNet(TDNNFNetConfig(output_dim=P, **NET), num_speakers=3)
        net.load_state_dict(from_satpu_variables(init))
        net.to(dtype)
        start = {k: p.detach().clone() for k, p in net.named_parameters()}
        trainer, out = _run_port(net, ng, d, n, spk=spk, freeze_filter=freeze)
        return start, trainer, out

    start, trainer, port = port_run(torch.float64, steps)
    assert trainer.frozen and all(freeze(n) for n in trainer.frozen)
    _check_steps(sat[:1], port[:1], lambda n: [0.0 if n in trainer.frozen else _lr(0)],
                 [1e-5])
    _, _, port32 = port_run(torch.float32, steps)

    def l2(a, b):
        return float(sum(float(((a[n].double() - b[n].double()) ** 2).sum()) for n in b) ** 0.5
                     / sum(float((b[n].double() ** 2).sum()) for n in b) ** 0.5)

    for k in range(1, steps):
        ref = from_satpu_variables(sat[k][0])
        own = l2(port32[k][0], port[k][0])
        assert l2(port[k][0], ref) <= max(10 * own, 1e-5), (k, l2(port[k][0], ref), own)
        for name in ("loss", "chain_objf", "spkadv_loss"):
            got, want, f32 = port[k][1][name], sat[k][1][name], port32[k][1][name]
            assert abs(got - want) <= max(10 * abs(f32 - got), 1e-5 * abs(want)), (k, name)
    final = port[-1][0]
    for n in trainer.frozen:
        assert torch.equal(final[n], start[n]), n
    moved = [n for n in final if n not in trainer.frozen and not torch.equal(final[n], start[n])]
    assert any(n.startswith("asi_") for n in moved)
    assert any(".prefinal_chain." in n for n in moved)
    assert all(np.isfinite(m["spkadv_loss"]) for _, m in port)


@pytest.mark.parametrize("ng", [False, True], ids=["ng_off", "ng_on"])
def test_bf16_step_tracks_f32(ng):
    """satpu's rule for the bf16 training policy, on the port."""
    from satpu_torch.chain.fst import (Arc, Fst, fst_to_arrays, linear_fst_from_pdf_sequence,
                                       pad_graph_arrays)
    from satpu_torch.chain.objf import DenominatorGraph, graphs_to_torch
    from satpu_torch.chain.trainer import ChainTrainer, ChainTrainOpts
    from satpu_torch.infer_helper import build_model

    Pd = 8
    den_fst = Fst()
    s = den_fst.add_state()
    states = [den_fst.add_state() for _ in range(Pd)]
    for j in range(Pd):
        den_fst.add_arc(s, Arc(j + 1, j + 1, np.log(Pd), states[j]))
    for i in range(Pd):
        for j in range(Pd):
            den_fst.add_arc(states[i], Arc(j + 1, j + 1, np.log(Pd), states[j]))
        den_fst.set_final(states[i], 0.0)
    den = DenominatorGraph.from_fst(den_fst, num_pdfs=Pd)
    rng = np.random.default_rng(0)
    wav = torch.from_numpy((rng.standard_normal((2, 16000)) * 0.1).astype(np.float32))
    graphs = graphs_to_torch(pad_graph_arrays(
        [fst_to_arrays(linear_fst_from_pdf_sequence(q)) for q in ([0, 1, 2], [3, 4, 5])]), "cpu")

    def run(dtype):
        model = build_model("asrbn_tdnnf", device="cpu", seed=0, output_dim=Pd, hidden_dim=16,
                            bottleneck_dim=8, prefinal_bottleneck_dim=8, p_dropout=0.0,
                            natural_gradient=ng, compute_dtype=dtype)
        frames = torch.full((2,), model.eval()(wav)[0].shape[1], dtype=torch.int32)
        trainer = ChainTrainer(model, den, ChainTrainOpts(lr=0.003, compute_dtype=dtype))
        return [float(trainer.step(wav, graphs, frames)["chain_objf"]) for _ in range(6)]

    f32, bf16 = run("float32"), run("bfloat16")
    assert np.isfinite(bf16).all(), bf16
    assert abs(bf16[0] - f32[0]) < 0.05 * abs(f32[0]) + 0.02, (f32, bf16)
    assert bf16[-1] > bf16[0], bf16
    assert bf16 != f32  # the policy changed the arithmetic


def test_wav2vec2_bf16_step_casts_per_layer(chain_data):
    """Under the bf16 policy the wav2vec2 front's convs and linears return
    bf16 and its layer norms f32, the master parameters stay f32, and the
    step's objf is finite and within satpu's 5% + 0.02 of the f32 step's."""
    from satpu_torch.chain.objf import graphs_to_torch
    from satpu_torch.chain.trainer import ChainTrainer, ChainTrainOpts
    from satpu_torch.infer_helper import build_model

    seen = {}

    def hook(name):
        def record(mod, inp, out):
            seen.setdefault(name, out.dtype)
        return record

    wav, graphs, frames = chain_data["batches"][0]
    objf = {}
    for dtype in ("float32", "bfloat16"):
        model = build_model("asrbn_tdnnf_wav2vec2", device="cpu", seed=0, output_dim=P,
                            bottleneck="vq", codebook_size=8, kernel_size_list=[3, 3, 3],
                            subsampling_factor_list=[1, 1, 1], compute_dtype=dtype,
                            wav2vec2=dict(W2V), **NET)
        if dtype == "bfloat16":
            enc = model.preprocessor.encoder.layers[0]
            enc.attention.q_proj.register_forward_hook(hook("linear"))
            enc.layer_norm.register_forward_hook(hook("layer_norm"))
            model.preprocessor.feature_extractor.conv_layers[0].conv.register_forward_hook(
                hook("conv"))
        trainer = ChainTrainer(model, chain_data["tden"],
                               ChainTrainOpts(lr=1e-3, compute_dtype=dtype))
        m = trainer.step(torch.from_numpy(wav), graphs_to_torch(graphs, "cpu"),
                         torch.from_numpy(frames))
        objf[dtype] = float(m["chain_objf"])
        assert all(p.dtype == torch.float32 for p in model.parameters())
    assert seen == {"linear": torch.bfloat16, "layer_norm": torch.float32,
                    "conv": torch.bfloat16}
    assert np.isfinite(objf["bfloat16"])
    assert abs(objf["bfloat16"] - objf["float32"]) < 0.05 * abs(objf["float32"]) + 0.02, objf
