"""satpu_torch's chain training step against satpu on the CPU, on a tiny
TDNN-F + VQ (dropout 0, weights, statistics and NG states carried across by
the weight bridge) over a 5-phone den graph. The network runs in f64 on
both sides (satpu under ``jax.enable_x64``) where the point is the
algorithm: the train-mode forward normalizes by the batch's own statistics,
which makes it ill-conditioned at f32 (see the first test).

- the train-mode forward (batch statistics, the VQ EMA update): outputs,
  new running statistics, new codebook, vq_loss and perplexity, rel <= 1e-6
  in f64, and the port's f32 forward rel <= 1e-3;
- the gradients of one train step after NG preconditioning, NG on and off,
  rel <= 1e-3 per tensor (satpu's are read back from its own jitted step
  with an optimizer that adds 1e6 x the gradient; the objective in f32 on
  both sides), the loss rel <= 1e-4, running statistics rel <= 1e-6;
- AdamW with clipping against optax (satpu's ``make_chain_optimizer``) on
  identical gradients over 3 steps with a schedule, with and without
  gradient accumulation: parameters rel <= 1e-6;
- the orthonormal constraint on every ``inner_nat`` weight, rel <= 1e-5;
- dropout: keep fraction within 1% of 0.9 on a large tensor, scale 1/keep.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import ASRBN_TINY, jax_variables_numpy, rel_err

P = 40  # pdfs of random_bigram_den(5, 3)
N_SAMPLES = 16000  # 1 s: 32 output frames
B = 3


def _cfg(ng: bool):
    return dict(ASRBN_TINY, output_dim=P, p_dropout=0.0, natural_gradient=ng)


@pytest.fixture(scope="module")
def chain_data():
    """Den graph (both sides), padded numerator graphs and waveforms."""
    from satpu.chain.fst import Fst as JFst
    from satpu.chain.objf import DenominatorGraph as JDen
    from satpu_torch.chain.fst import fst_rmepsilon, fst_to_arrays, pad_graph_arrays
    from satpu_torch.chain.objf import DenominatorGraph
    from satpu_torch.chain.prep import numerator_fst, random_bigram_den, random_phone_walk

    fst, tree, trans = random_bigram_den(5, 3, seed=2)
    assert tree.num_pdfs == P
    rng = np.random.default_rng(7)
    frames = np.full(B, ((N_SAMPLES + 80) // 160 - 2) // 3, np.int32)
    graphs = pad_graph_arrays([fst_to_arrays(fst_rmepsilon(numerator_fst(
        random_phone_walk(trans, 9, rng), tree))) for _ in range(B)])
    wav = (rng.standard_normal((B, N_SAMPLES)) * 0.1).astype(np.float32)
    return {"wav": wav, "graphs": graphs, "frames": frames,
            "tden": DenominatorGraph.from_fst(fst, P),
            "jden": JDen.from_fst(JFst.from_text(fst.to_text()), P)}


def _satpu_state(ng: bool):
    """satpu's TDNNFNet and initial ChainTrainState (optimizer: + 1e6 g)."""
    import optax

    from satpu.chain.trainer import init_chain_state
    from satpu.models.asrbn import TDNNFNet as JNet
    from satpu.models.asrbn import TDNNFNetConfig as JCfg

    jnet = JNet(JCfg(**_cfg(ng)))
    opt = optax.scale(1e6)
    state = init_chain_state(jnet, jax.random.PRNGKey(0), np.zeros((2, 8000), np.float32), opt)
    return jnet, opt, state


def _port_net(state, ng: bool):
    from satpu_torch.models.asrbn import TDNNFNet, TDNNFNetConfig
    from satpu_torch.models.convert import from_satpu_variables

    variables = jax_variables_numpy({"params": state.params, "batch_stats": state.batch_stats,
                                     "vq_stats": state.vq_stats})
    net = TDNNFNet(TDNNFNetConfig(**_cfg(ng)))
    net.load_state_dict(from_satpu_variables(variables))
    return net


def _f64(tree):
    """Every float leaf as a float64 array (call under ``jax.enable_x64``)."""
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating)
        else a, tree)


def _buffers(params, tree, coll):
    """satpu batch_stats / vq_stats -> {port buffer name: tensor}."""
    from satpu_torch.models.convert import from_satpu_variables

    sd = from_satpu_variables(jax_variables_numpy({"params": params, coll: tree}))
    names = set(from_satpu_variables(jax_variables_numpy({"params": params})))
    return {k: v for k, v in sd.items() if k not in names}


def test_train_mode_forward_matches_satpu(chain_data):
    """Batch statistics, EMA codebook update, vq_loss and perplexity, both
    sides in f64: rel <= 1e-6. The port in f32 against that: rel <= 1e-3
    (normalizing by the batch's own statistics makes the train-mode forward
    ill-conditioned at f32: the port's f32 forward lies about 2e-4 from the
    f64 one on this input, and so does satpu's)."""
    jnet, _, state = _satpu_state(False)
    wav = chain_data["wav"]
    variables = {"params": state.params, "batch_stats": state.batch_stats,
                 "vq_stats": state.vq_stats}
    with jax.enable_x64():
        (ref_chain, ref_xent), new = jax.tree_util.tree_map(np.asarray, jnet.apply(
            _f64(variables), wav.astype(np.float64), train=True,
            mutable=["batch_stats", "vq_stats", "aux_loss", "aux_metric"]))
    net = _port_net(state, False).double().train()
    chain, xent, aux = net(torch.from_numpy(wav).double())
    assert rel_err(chain.detach().numpy(), ref_chain) <= 1e-6
    assert rel_err(xent.detach().numpy(), ref_xent) <= 1e-6
    vq_loss = float(jax.tree_util.tree_leaves(new["aux_loss"])[0].sum())
    perplexity = float(jax.tree_util.tree_leaves(new["aux_metric"])[0].mean())
    assert rel_err(aux["vq_loss"].item(), vq_loss) <= 1e-6
    assert rel_err(aux["vq_perplexity"].item(), perplexity) <= 1e-6
    sd = net.state_dict()
    for coll in ("batch_stats", "vq_stats"):
        ref = _buffers(state.params, new[coll], coll)
        assert ref
        for k, v in ref.items():
            assert rel_err(sd[k].numpy(), v.numpy()) <= 1e-6, k
    with torch.no_grad():
        chain32 = _port_net(state, False).train()(torch.from_numpy(wav))[0]
    assert rel_err(chain32.numpy(), ref_chain) <= 1e-3


@pytest.mark.parametrize("ng", [True, False], ids=["ng_on", "ng_off"])
def test_train_step_gradients_match_satpu(chain_data, ng):
    """One step: the preconditioned gradients (NG on) or the raw ones, and
    the loss; the running statistics after it. The network runs in f64 on
    both sides and the objective in f32, as satpu's step runs it."""
    from satpu.chain.ngsgd import unstack_ng_state
    from satpu.chain.trainer import make_chain_train_step
    from satpu_torch.chain.objf import graphs_to_torch
    from satpu_torch.chain.trainer import ChainTrainer
    from satpu_torch.models.convert import from_satpu_variables, ng_states_from_satpu

    d = chain_data
    jnet, opt, state = _satpu_state(ng)
    assert bool(state.ng_state) == ng
    net = _port_net(state, ng).double()
    ng_states = (ng_states_from_satpu(jax_variables_numpy(unstack_ng_state(state.ng_state)))
                 if ng else None)
    with jax.enable_x64():
        step = jax.jit(make_chain_train_step(jnet, d["jden"], opt))
        graphs = {k: jnp.asarray(v) for k, v in d["graphs"].items()}
        state64 = _f64(state)
        new, metrics = jax.tree_util.tree_map(np.asarray, step(
            state64, d["wav"].astype(np.float64), graphs, jnp.asarray(d["frames"]),
            jax.random.PRNGKey(0)))
        ref_grads = from_satpu_variables({"params": jax_variables_numpy(
            jax.tree_util.tree_map(lambda a, b: (a - np.asarray(b)) / 1e6, new.params,
                                   state64.params))})

    trainer = ChainTrainer(net, d["tden"], ng_states=ng_states)
    if ng:
        assert set(trainer.ng_slots) == set(ng_states)
    loss, m = trainer.compute_grads(torch.from_numpy(d["wav"]),
                                    graphs_to_torch(d["graphs"], "cpu"),
                                    torch.from_numpy(d["frames"]))
    assert rel_err(loss.item(), float(metrics["loss"])) <= 1e-4
    assert rel_err(m["chain_objf"].item(), float(metrics["chain_objf"])) <= 1e-4
    grads = {n: p.grad for n, p in net.named_parameters()}
    assert set(grads) == set(ref_grads)
    top = max(g.abs().max().item() for g in ref_grads.values())
    for n, g in grads.items():
        ref = ref_grads[n].numpy()
        if np.abs(ref).max() <= 1e-9 * top:
            # zero in exact arithmetic (the bias of a linearB without NG,
            # whose constant the next batch norm removes): rounding noise
            assert g.abs().max().item() <= 1e-6 * top, n
        else:
            assert rel_err(g.numpy(), ref) <= 1e-3, n
    sd = net.state_dict()
    for k, v in _buffers(state.params, new.batch_stats, "batch_stats").items():
        assert rel_err(sd[k].numpy(), v.numpy()) <= 1e-6, k


@pytest.mark.parametrize("acc", [1, 2], ids=["every_step", "grad_acc_2"])
def test_adamw_with_clipping_matches_optax(chain_data, acc):
    """The same raw gradients (some beyond the clip value of 5) through the
    port's optimizer step and satpu's optax chain, lr from a schedule."""
    import optax

    from satpu.chain.trainer import ChainTrainOpts as JOpts
    from satpu.chain.trainer import make_chain_optimizer, with_injected_lr
    from satpu_torch.chain.trainer import ChainTrainer

    _, _, state = _satpu_state(False)
    net = _port_net(state, False)
    trainer = ChainTrainer(net, chain_data["tden"], grad_acc_steps=acc)
    names = [n for n, _ in net.named_parameters()]
    params = {n: p.detach().numpy().copy() for n, p in net.named_parameters()}
    opt = make_chain_optimizer(JOpts(lr=1e-3), grad_acc_steps=acc)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    opt_state = opt.init(jp)
    rng = np.random.default_rng(11)
    for k in range(3):
        lr = 1e-3 * 0.5 ** k
        grads = {n: (rng.standard_normal(v.shape) * 3).astype(np.float32)
                 for n, v in params.items()}
        for n, p in net.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        trainer.apply_grads(lr)
        opt_state = with_injected_lr(opt_state, lr)
        updates, opt_state = opt.update({n: jnp.asarray(g) for n, g in grads.items()},
                                        opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        got = dict(net.named_parameters())
        for n in names:
            assert rel_err(got[n].detach().numpy(), np.asarray(jp[n])) <= 1e-6, (k, n)


def test_orthonormal_constraint_matches_satpu():
    from satpu.chain.trainer import apply_orthonormal_constraint
    from satpu.models.tdnnf import constrain_orthonormal as jco
    from satpu_torch.models.convert import from_satpu_variables
    from satpu_torch.models.tdnnf import constrain_orthonormal, orthonormal_weights

    rng = np.random.default_rng(5)
    for shape, scale in (((12, 30), -1.0), ((30, 12), -1.0), ((16, 16), 1.0)):
        M = (rng.standard_normal(shape) * 0.2).astype(np.float32)
        ref = np.asarray(jco(jnp.asarray(M), scale))
        assert rel_err(constrain_orthonormal(torch.from_numpy(M), scale).numpy(), ref) <= 1e-5
    # the whole tiny net: the same weights constrained, the rest untouched
    _, _, state = _satpu_state(False)
    net = _port_net(state, False)
    ref = from_satpu_variables({"params": jax_variables_numpy(
        apply_orthonormal_constraint(state.params))})
    names = {n for n, _ in orthonormal_weights(net)}
    assert names and all(".inner_nat." in n for n in names)
    with torch.no_grad():
        for n, w in orthonormal_weights(net):
            w.copy_(constrain_orthonormal(w, -1.0))
    before = _port_net(state, False).state_dict()
    for n, v in net.state_dict().items():
        assert rel_err(v.numpy(), ref[n].numpy() if n in ref else before[n].numpy()) <= 1e-5, n
        assert (n in names) == (not torch.equal(v, before[n])), n


def test_dropout_keep_fraction_and_scale():
    from satpu_torch.models.asrbn import TDNNFNet, TDNNFNetConfig

    net = TDNNFNet(TDNNFNetConfig(**dict(ASRBN_TINY, p_dropout=0.1))).train()
    x = torch.ones(64, 32, 512)
    g = torch.Generator().manual_seed(0)
    y = net._dropout(x, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.9) <= 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    # the generator decides the mask; eval mode keeps everything
    assert torch.equal(y, net._dropout(x, torch.Generator().manual_seed(0)))
    assert torch.equal(net.eval()._dropout(x, g), x)
