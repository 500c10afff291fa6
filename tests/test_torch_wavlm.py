"""The port's WavLM encoder against satpu's on the CPU, at small widths
(hidden 32, 2 layers, 4 heads, 16-channel convs of total stride 320, 32
buckets over a distance of 50, so that 50 frames reach the log buckets),
in both layouts: large-style (a layer norm after every extractor conv,
conv bias, pre-norm transformer) and base-style (a group norm after conv
0, no conv bias, post-norm), with satpu's random weights and randomized
norms carried across by ``convert.from_satpu_wavlm``.

- ``relative_positions_bucket`` equals satpu's, entry for entry, at T in
  {1, 2, 49, 149, 500}, at these buckets and at WavLM-large's (320 over
  800);
- every hidden state of ``return_all`` (the positional-conv state, each
  layer's, the last through the final layer norm), f32: rel <= 1e-4;
- satpu's bf16 policy against satpu's own: each state's dtype as satpu's,
  rel <= 3e-2 (as wav2vec2's);
- the front end (softmax-weighted sum, instance norm): rel <= 1e-4, and
  channels-first; the bucket indices it caches under ``inference_mode``
  serve a later training step;
- ``convert_wavlm`` on a HuggingFace ``WavLMModel`` state_dict equals
  satpu's ``convert_wavlm`` carried across, exactly (with and without a
  ``wavlm.`` prefix), and the imported model gives HF's last hidden state
  (rel 1e-4); ``models/wavlm.py`` imports no ``transformers``.
"""
import ast
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import jax_variables_numpy, randomize_bn, rel_err

CONVS = dict(conv_dim=(16, 16, 16), conv_kernel=(10, 8, 4), conv_stride=(5, 8, 8))
SMALL = dict(CONVS, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=64, num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
             num_buckets=32, max_bucket_distance=50)
STYLES = {"large": dict(feat_extract_norm="layer", conv_bias=True),
          "base": dict(do_stable_layer_norm=False)}


@pytest.mark.parametrize("T", [1, 2, 49, 149, 500])
@pytest.mark.parametrize("buckets,distance", [(32, 50), (320, 800)])
def test_relative_positions_bucket_is_satpus(T, buckets, distance):
    from satpu.models.wavlm import relative_positions_bucket as jbucket
    from satpu_torch.models.wavlm import relative_positions_bucket

    pos = np.arange(T)
    rel = pos[None, :] - pos[:, None]
    got, want = relative_positions_bucket(rel, buckets, distance), jbucket(rel, buckets, distance)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert got.max() < buckets


@pytest.fixture(scope="module", params=sorted(STYLES))
def models(request):
    from satpu.models.wavlm import WavLMConfig as JCfg
    from satpu.models.wavlm import WavLmFrontEnd as JFront
    from satpu_torch.models.convert import from_satpu_xvector
    from satpu_torch.models.wavlm import WavLMConfig, WavLmFrontEnd

    kw = dict(SMALL, **STYLES[request.param])
    jm = JFront(JCfg(**kw))
    wav = (np.random.default_rng(0).standard_normal((2, 16000)) * 0.1).astype(np.float32)
    params = randomize_bn({"params": jax_variables_numpy(
        jax.jit(jm.init)(jax.random.PRNGKey(0), wav)["params"])}, seed=3)["params"]
    pm = WavLmFrontEnd(WavLMConfig(**kw))
    # the x-vector bridge's preprocessor scopes
    sd = {k[len("preprocessor."):]: v
          for k, v in from_satpu_xvector({"params": {"preprocessor": params}}).items()}
    assert set(sd) == set(pm.state_dict()), set(sd) ^ set(pm.state_dict())
    pm.load_state_dict(sd)
    return request.param, jm, {"params": params}, pm.eval(), wav


def test_hidden_states_match_satpu(models):
    from satpu.models.wavlm import WavLMModel as JModel
    from satpu.models.wavlm import WavLMConfig as JCfg

    style, _, variables, pm, wav = models
    jm = JModel(JCfg(**dict(SMALL, **STYLES[style])))
    ref = jax.jit(lambda v, w: jm.apply(v, w, return_all=True))(
        {"params": variables["params"]["feature_extract"]}, wav)
    with torch.no_grad():
        got = pm.feature_extract(torch.from_numpy(wav), return_all=True)
        last = pm.feature_extract(torch.from_numpy(wav))
    assert len(got) == len(ref) == SMALL["num_hidden_layers"] + 1
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (2, 50, 32)
        assert rel_err(g.numpy(), r) <= 1e-4
    assert torch.equal(last, got[-1])


def test_bf16_policy_matches_satpus(models):
    from satpu.models import torchlayers as jtl
    from satpu.models.wavlm import WavLMModel as JModel
    from satpu.models.wavlm import WavLMConfig as JCfg
    from satpu_torch.models.torchlayers import autocast

    style, _, variables, pm, wav = models
    jm = JModel(JCfg(**dict(SMALL, **STYLES[style])))
    with jtl.autocast(jnp.bfloat16):
        ref = jm.apply({"params": variables["params"]["feature_extract"]}, wav, return_all=True)
    with torch.no_grad(), autocast(torch.bfloat16):
        got = pm.feature_extract(torch.from_numpy(wav), return_all=True)
        front = pm(torch.from_numpy(wav))
    # pre-norm: a bf16 residual stream, the last state through the f32
    # layer norm; post-norm: every state out of an f32 layer norm
    want = ([jnp.bfloat16] * (len(ref) - 1) + [jnp.float32] if style == "large"
            else [jnp.float32] * len(ref))
    assert [r.dtype for r in ref] == want
    for g, r in zip(got, ref):
        assert str(g.dtype).split(".")[-1] == str(r.dtype)
        assert rel_err(g.float().numpy(), np.asarray(r, np.float32)) <= 3e-2
    assert front.dtype == torch.float32
    with torch.no_grad():
        f32 = pm.feature_extract(torch.from_numpy(wav), return_all=True)
    assert rel_err(got[-1].float().numpy(), f32[-1].numpy()) > 1e-4  # the policy acted


def test_front_end_matches_satpu(models):
    _, jm, variables, pm, wav = models
    ref = np.asarray(jax.jit(jm.apply)(variables, wav))  # [B, frames, hidden]
    with torch.no_grad():
        got = pm(torch.from_numpy(wav)).numpy()  # [B, hidden, frames]
    assert got.shape == (2, 32, 50) and ref.shape == (2, 50, 32)
    assert rel_err(got.transpose(0, 2, 1), ref) <= 1e-4
    assert np.abs(got.mean(axis=2)).max() <= 1e-4  # instance-normed over time


def test_buckets_cached_at_inference_serve_training(models):
    """The bucket indices cached by an inference_mode forward (x-vector
    extraction) index the embedding in a later training step."""
    _, _, _, pm, wav = models
    x = torch.from_numpy(wav[:, :12000])
    with torch.inference_mode():
        pm(x)
    pm.feature_extract(x)[0].sum().backward()
    grad = pm.feature_extract.encoder.layers[0].attention.rel_attn_embed.weight.grad
    assert grad is not None and float(grad.abs().max()) > 0
    pm.zero_grad(set_to_none=True)


def _hf_wavlm(style):
    from transformers import WavLMConfig as HFConfig
    from transformers import WavLMModel as HFModel

    kw = dict(SMALL, **STYLES[style])
    cfg = HFConfig(
        vocab_size=32, hidden_size=kw["hidden_size"], num_hidden_layers=kw["num_hidden_layers"],
        num_attention_heads=kw["num_attention_heads"], intermediate_size=kw["intermediate_size"],
        conv_dim=list(kw["conv_dim"]), conv_kernel=list(kw["conv_kernel"]),
        conv_stride=list(kw["conv_stride"]), num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4, num_buckets=32, max_bucket_distance=50,
        do_stable_layer_norm=kw.get("do_stable_layer_norm", True),
        feat_extract_norm=kw.get("feat_extract_norm", "group"),
        conv_bias=kw.get("conv_bias", False), hidden_dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, feat_proj_dropout=0.0, layerdrop=0.0,
        apply_spec_augment=False)
    torch.manual_seed(0)
    model = HFModel(cfg).eval()
    # HF initializes the norms to ones / zeros and gru_rel_pos_const to
    # ones: move every parameter so that a mis-mapped one shows
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    return kw, model


@pytest.mark.parametrize("style", sorted(STYLES))
def test_hf_importer_matches_satpus(style):
    from satpu.models.wavlm import convert_wavlm as jconvert
    from satpu_torch.models.convert import from_satpu_wavlm
    from satpu_torch.models.wavlm import WavLMConfig, WavLMModel, convert_wavlm

    kw, hf = _hf_wavlm(style)
    sd = hf.state_dict()
    got = convert_wavlm(sd)
    ref = from_satpu_wavlm(jconvert(sd)["params"])
    pm = WavLMModel(WavLMConfig(**kw))
    assert set(got) == set(ref) == set(pm.state_dict())
    assert "encoder.layers.0.attention.rel_attn_embed.weight" in got
    assert "encoder.layers.1.attention.rel_attn_embed.weight" not in got
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k].numpy(), err_msg=k)
    prefixed = convert_wavlm({"wavlm." + k: v for k, v in sd.items()})
    assert set(prefixed) == set(got)
    assert all(torch.equal(prefixed[k], got[k]) for k in got)
    pm.load_state_dict(got)
    x = (np.random.default_rng(2).standard_normal((2, 16000)) * 0.1).astype(np.float32)
    with torch.no_grad():
        want = hf(torch.from_numpy(x)).last_hidden_state.numpy()
        out = pm.eval()(torch.from_numpy(x)).numpy()
    assert out.shape == want.shape
    assert rel_err(out, want) <= 1e-4


def test_wavlm_module_imports_no_transformers():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "satpu_torch", "models", "wavlm.py")
    roots = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    assert "transformers" not in roots and roots <= {"__future__", "dataclasses", "math",
                                                      "typing", "numpy", "torch"}


def test_wavlm_large_shapes():
    """WavLM-large's config and the module's parameter count (316.6 M, the
    front end adds the 25 layer weights)."""
    from satpu_torch.models.wavlm import WavLMConfig, WavLmFrontEnd

    c = WavLMConfig.large()
    assert (c.hidden_size, c.num_hidden_layers, c.num_attention_heads, c.intermediate_size,
            c.num_buckets, c.max_bucket_distance, c.do_stable_layer_norm,
            c.feat_extract_norm, c.conv_bias, c.num_conv_pos_embeddings,
            c.num_conv_pos_embedding_groups) == (1024, 24, 16, 4096, 320, 800, True, "layer",
                                                 True, 128, 16)
    assert WavLMConfig.from_dict(__import__("dataclasses").asdict(c)) == c
    with torch.device("meta"):
        front = WavLmFrontEnd(c)
    n = sum(p.numel() for p in front.parameters())
    assert front.feature_weight.shape == (25,)
    assert 3.1e8 < n < 3.2e8, n
