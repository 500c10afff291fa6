"""The VQ codebook's collapse on noise egs is satpu's too (ROADMAP Queue 3,
item 3): satpu's chain train step and the port's ``ChainTrainer`` from the
same bridged weights, codebook and NG states (a TDNN-F + VQ-48 at hidden
width 32, dropout 0, NG on, AdamW lr 1e-3 with clipping), on the same
noise egs (two batches of 4 x 3 s, alternated: the 4 steps of
``chip_smoke.py``'s train phase), at f32.

Both collapse: the codebook perplexity (exp of the entropy of the code
usage over the batch's frames) is 1.2412 after the first step on both
sides and 1.0 (one code) after each of the next three; held at 1e-3 of
each other step by step, and below 1.5 at the end."""
import numpy as np
import pytest
import torch

import jax

from torch_parity import ASRBN_TINY, jax_variables_numpy

P = 40  # pdfs of random_bigram_den(5, 3)
CFG = dict(ASRBN_TINY, output_dim=P, codebook_size=48, p_dropout=0.0, natural_gradient=True)
B, SAMPLES, STEPS = 4, 48000, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches():
    from satpu_torch.chain.fst import fst_rmepsilon, fst_to_arrays, pad_graph_arrays
    from satpu_torch.chain.prep import numerator_fst, random_bigram_den, random_phone_walk

    fst, tree, trans = random_bigram_den(5, 3, seed=2)
    rng = np.random.default_rng(11)
    frames = np.full(B, ((SAMPLES + 80) // 160 - 2) // 3, np.int32)
    batches = []
    for _ in range(2):
        graphs = pad_graph_arrays([fst_to_arrays(fst_rmepsilon(numerator_fst(
            random_phone_walk(trans, 30, rng), tree))) for _ in range(B)])
        wav = (rng.standard_normal((B, SAMPLES)) * 0.1).astype(np.float32)
        batches.append((wav, graphs, frames))
    return fst, batches


def test_codebook_collapses_in_satpu_and_the_port():
    import jax.numpy as jnp

    from satpu.chain.fst import Fst as JFst
    from satpu.chain.ngsgd import unstack_ng_state
    from satpu.chain.objf import DenominatorGraph as JDen
    from satpu.chain.trainer import ChainTrainOpts as JOpts
    from satpu.chain.trainer import (init_chain_state, make_chain_optimizer,
                                     make_chain_train_step)
    from satpu.models.asrbn import TDNNFNet as JNet
    from satpu.models.asrbn import TDNNFNetConfig as JCfg
    from satpu_torch.chain.objf import DenominatorGraph, graphs_to_torch
    from satpu_torch.chain.trainer import ChainTrainer, ChainTrainOpts
    from satpu_torch.models.asrbn import TDNNFNet, TDNNFNetConfig
    from satpu_torch.models.convert import from_satpu_variables, ng_states_from_satpu

    fst, batches = _batches()
    jnet = JNet(JCfg(**CFG))
    opt = make_chain_optimizer(JOpts(lr=1e-3))
    state = init_chain_state(jnet, jax.random.PRNGKey(0), np.zeros((2, 8000), np.float32), opt)
    net = TDNNFNet(TDNNFNetConfig(**CFG))
    net.load_state_dict(from_satpu_variables(jax_variables_numpy(
        {"params": state.params, "batch_stats": state.batch_stats,
         "vq_stats": state.vq_stats})))
    trainer = ChainTrainer(net, DenominatorGraph.from_fst(fst, P), ChainTrainOpts(lr=1e-3),
                           ng_states=ng_states_from_satpu(jax_variables_numpy(
                               unstack_ng_state(state.ng_state))))
    step = jax.jit(make_chain_train_step(jnet, JDen.from_fst(JFst.from_text(fst.to_text()), P),
                                         opt, JOpts(lr=1e-3)))
    satpu_ppl, port_ppl = [], []
    for i in range(STEPS):
        wav, graphs, frames = batches[i % 2]
        state, m = step(state, wav, {k: jnp.asarray(v) for k, v in graphs.items()},
                        jnp.asarray(frames), jax.random.PRNGKey(i))
        satpu_ppl.append(float(m["vq_perplexity"]))
        pm = trainer.step(torch.from_numpy(wav), graphs_to_torch(graphs, "cpu"),
                          torch.from_numpy(frames))
        port_ppl.append(float(pm["vq_perplexity"]))
    assert satpu_ppl[-1] < 1.5 and port_ppl[-1] < 1.5, (satpu_ppl, port_ppl)
    for s, p in zip(satpu_ppl, port_ppl):
        assert abs(s - p) <= 1e-3 * s, (satpu_ppl, port_ppl)
