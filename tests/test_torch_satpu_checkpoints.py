"""The port reads satpu's checkpoint files (flax msgpack) without msgpack or
flax (``satpu_torch.utils.flax_msgpack``), on the CPU.

- msgpack's formats at every width (fix / 8 / 16 / 32 / 64-bit integers,
  float32 / float64, str, bin, arrays, maps, ext types of every length)
  decode to what ``msgpack.unpackb`` gives; truncated data and trailing
  bytes raise;
- trees written by satpu's ``save_checkpoint`` read back as satpu's
  ``load_checkpoint`` reads them, bit for bit: f32, bf16, int32, int64 and
  bool leaves, 0-d and empty arrays, numpy scalars, a complex, optax's
  AdamW state (namedtuples saved as nested lists), and arrays chunked by
  flax (``MAX_CHUNK_SIZE`` set small);
- ``infer_helper.load_model`` on a satpu checkpoint of every registry model
  (``asrbn_tdnnf``, ``anonymizer_tdnnf_hifigan``, ``asv_xvector`` with the
  mel and the WavLM frontend, ``asrbn_tdnnf_wav2vec2``,
  ``asrbn_tdnnf_spkadv``; satpu's random weights, randomized norms) gives
  satpu's outputs: rel 1e-4 (x-vector cosine >= 0.9999);
- in a process where ``msgpack`` and ``flax`` cannot be imported, the
  reader gives the same state_dicts for all of them.
"""
import dataclasses
import os
import subprocess
import sys

import msgpack
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_parity import (ANON_TINY, ASRBN_TINY, XV_TINY, jax_variables_numpy, randomize_bn,
                          rel_err)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _norm(x):
    """A decoded value with ext values as ("ext", code, bytes)."""
    from satpu_torch.utils.flax_msgpack import ExtType

    if isinstance(x, ExtType):
        return ("ext", x.code, bytes(x.data))
    if isinstance(x, msgpack.ExtType):
        return ("ext", x.code, bytes(x.data))
    if isinstance(x, dict):
        return {_norm(k): _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33,
        -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]


@pytest.mark.parametrize("value", [
    INTS,
    [None, True, False, 0.5, -1e300, float("inf")],
    ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000],
    [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65536],
    [list(range(15)), list(range(16)), list(range(65536))],
    [{str(i): i for i in range(15)}, {str(i): i for i in range(16)},
     {i: [i] for i in range(65536)}],
    [msgpack.ExtType(42, b"x" * n) for n in (1, 2, 4, 8, 16, 3, 255, 256, 65535, 65536)],
], ids=["ints", "nil-bool-float", "str", "bin", "arrays", "maps", "ext"])
@pytest.mark.parametrize("single_float", [False, True])
def test_msgpack_formats_decode_as_msgpack_does(value, single_float):
    from satpu_torch.utils import flax_msgpack

    data = msgpack.packb(value, use_bin_type=True, use_single_float=single_float)
    got = flax_msgpack._whole(memoryview(data))
    want = msgpack.unpackb(data, raw=False, strict_map_key=False)
    assert _norm(got) == _norm(want)


def test_malformed_data_raises():
    from satpu_torch.utils import flax_msgpack

    data = msgpack.packb({"a": [1, 2, 3]})
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.msgpack_restore(data[:-1])
    with pytest.raises(ValueError, match="trailing"):
        flax_msgpack.msgpack_restore(data + b"\x00")
    with pytest.raises(ValueError, match="unknown msgpack type"):
        flax_msgpack.msgpack_restore(b"\xc1")


def _same_tree(got, want, path=""):
    """Bit-for-bit equality of the port's reading and flax's."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype == jnp.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == want.shape, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert np.shape(got) == np.shape(want), path
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


def _optax_state():
    import optax

    params = {"w": np.ones((3, 2), np.float32), "b": np.zeros((2,), np.float32)}
    opt = optax.adamw(1e-3)
    state = opt.init(params)
    grads = {"w": np.full((3, 2), 0.5, np.float32), "b": np.ones((2,), np.float32)}
    return opt.update(grads, state, params)[1]


@pytest.mark.parametrize("chunk", [None, 64])
def test_reader_gives_flax_arrays_bit_for_bit(tmp_path, monkeypatch, chunk):
    import flax.serialization

    from satpu.utils.checkpoint import load_checkpoint, save_checkpoint
    from satpu_torch.utils.flax_msgpack import load_satpu_checkpoint

    if chunk:  # flax splits arrays over MAX_CHUNK_SIZE bytes
        monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", chunk)
    rng = np.random.default_rng(0)
    state = {
        "variables": {"params": {"dense": {"kernel": rng.standard_normal((7, 5)).astype(
            np.float32), "bias": rng.standard_normal((1, 5)).astype(np.float32)}},
            "half": jnp.asarray(rng.standard_normal((3, 11)), jnp.bfloat16)},
        "ints": np.arange(-20, 20, dtype=np.int32).reshape(4, 10),
        "longs": np.arange(50, dtype=np.int64) * (2**40),
        "mask": rng.random((6, 3)) > 0.5,
        "scalar": np.array(3.25, np.float32), "empty": np.zeros((0, 4), np.float32),
        "step": np.int32(17), "half_scalar": jnp.bfloat16(1.5),
        "f64": rng.standard_normal(9), "opt_state": _optax_state(),
        "nested": [[np.ones(3, np.float32), None], {"k": np.float32(2.0)}],
        "big": {"table": rng.standard_normal((40, 3)).astype(np.float32)},
    }
    path = str(tmp_path / "state.ckpt")
    meta = {"model_id": "x", "build_params": {"a": [1, 2]}, "epoch": 3}
    save_checkpoint(path, meta, state)
    if chunk:
        raw = msgpack.unpackb(open(path, "rb").read(), raw=False)
        assert "__msgpack_chunked_array__" in raw["state"]["big"]["table"]
        assert "__msgpack_chunked_array__" in raw["state"]["variables"]["params"]["dense"][
            "kernel"]
    ref_meta, ref = load_checkpoint(path)
    got_meta, got = load_satpu_checkpoint(path)
    assert got_meta == ref_meta == meta
    _same_tree(got, ref)
    # the complex ext (code 2) that satpu's trees never hold, through flax's writer
    blob = flax.serialization.msgpack_serialize({"c": complex(1.5, -2.0), "x": [np.float64(1)]})
    from satpu_torch.utils.flax_msgpack import msgpack_restore

    _same_tree(msgpack_restore(blob), flax.serialization.msgpack_restore(blob))


# ---------------------------------------------------------------------------
# load_model on satpu checkpoints of every registry model
# ---------------------------------------------------------------------------

W2V = dict(conv_dim=(16, 16, 16), conv_kernel=(10, 8, 4), conv_stride=(5, 8, 8),
           hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
           num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
WAVLM = dict(W2V, num_buckets=32, max_bucket_distance=50, feat_extract_norm="layer",
             conv_bias=True)
NET = dict(hidden_dim=32, bottleneck_dim=16, prefinal_bottleneck_dim=16)
CASES = ["asrbn_tdnnf", "anonymizer_tdnnf_hifigan", "asv_xvector", "asv_xvector_wavlm",
         "asrbn_tdnnf_wav2vec2", "asrbn_tdnnf_spkadv"]


def _satpu_case(name):
    """(model_id, build_params, satpu module, its init args, init kwargs,
    apply -> outputs)."""
    wav = np.zeros((1, 16000), np.float32)
    if name == "asrbn_tdnnf":
        from satpu.models.asrbn import TDNNFNet, TDNNFNetConfig

        params = dict(ASRBN_TINY)
        return "asrbn_tdnnf", params, TDNNFNet(TDNNFNetConfig(**params)), (wav,), {}
    if name == "anonymizer_tdnnf_hifigan":
        from satpu.models.anonymizer import AnonymizationNet, AnonymizerConfig
        from satpu.models.asrbn import TDNNFNetConfig

        params = dict(ANON_TINY, asrbn=dict(ASRBN_TINY))
        net = AnonymizationNet(AnonymizerConfig(asrbn=TDNNFNetConfig(**ASRBN_TINY), **ANON_TINY))
        f0 = np.full((1, 50), 120.0, np.float32)
        return ("anonymizer_tdnnf_hifigan", params, net,
                (wav, f0, np.zeros((1,), np.int32)), {"method": net.convert})
    if name.startswith("asv_xvector"):
        from satpu.models.wavlm import WavLMConfig
        from satpu.sidekit.xvector import XVectorConfig, build_xvector

        params = dict(XV_TINY)
        kw = dict(params)
        if name.endswith("wavlm"):
            params.update(frontend="wavlm", wavlm=dict(WAVLM))
            kw.update(frontend="wavlm", wavlm=WavLMConfig(**WAVLM))
        return "asv_xvector", params, build_xvector(XVectorConfig(**kw)), (wav,), {
            "train": False}
    if name == "asrbn_tdnnf_wav2vec2":
        from satpu.models.asrbn import TDNNFNetConfig, Wav2Vec2TDNNFNet
        from satpu.models.wav2vec2 import Wav2Vec2Config

        params = dict(NET, output_dim=24, bottleneck="vq", codebook_size=8, wav2vec2=dict(W2V))
        net = Wav2Vec2TDNNFNet(TDNNFNetConfig(**dict(NET, output_dim=24, bottleneck="vq",
                                                     codebook_size=8)), Wav2Vec2Config(**W2V))
        return "asrbn_tdnnf_wav2vec2", params, net, (wav,), {}
    from satpu.models.asrbn import TDNNFNetConfig
    from satpu.models.spkadv import SpkAdvTDNNFNet

    params = dict(NET, output_dim=24, num_speakers=4)
    return ("asrbn_tdnnf_spkadv", params,
            SpkAdvTDNNFNet(TDNNFNetConfig(**dict(NET, output_dim=24)), num_speakers=4),
            (wav,), {})


@pytest.fixture(scope="module")
def satpu_checkpoints(tmp_path_factory):
    """{case: (path, satpu module, variables)}: each written by satpu's
    ``save_model`` from satpu's random init with randomized norms."""
    from satpu import infer_helper as jhelper

    d = tmp_path_factory.mktemp("satpu_ckpts")
    out = {}
    for i, name in enumerate(CASES):
        model_id, params, net, args, kw = _satpu_case(name)
        v = randomize_bn(jax_variables_numpy(jax.jit(lambda key, *a: net.init(key, *a, **kw))(
            jax.random.PRNGKey(i), *args)), seed=i)
        path = str(d / f"{name}.ckpt")
        jhelper.save_model(path, model_id, params, v,
                           extra_meta={"speakers": ["a", "b", "c"]} if "anon" in name else None)
        out[name] = (path, net, v)
    return out


@pytest.mark.parametrize("name", CASES)
def test_load_model_on_satpu_checkpoints_gives_satpus_outputs(satpu_checkpoints, name):
    from satpu_torch import infer_helper

    path, net, v = satpu_checkpoints[name]
    with open(path, "rb") as f:
        assert f.read(2) != b"PK"  # msgpack, not a torch.save zip
    model, meta = infer_helper.load_model(path, device="cpu")
    assert meta["model_id"] == _satpu_case(name)[0]
    rng = np.random.default_rng(5)
    wav = (rng.standard_normal((2, 16000)) * 0.1).astype(np.float32)
    x = torch.from_numpy(wav)
    model.eval()
    with torch.no_grad():
        if name == "anonymizer_tdnnf_hifigan":
            assert meta["speakers"] == ["a", "b", "c"]
            f0 = (np.abs(rng.standard_normal((2, 50))) * 30 + 100).astype(np.float32)
            f0[:, :6] = 0.0
            tid = np.array([0, 2], np.int32)
            ref = [jax.jit(lambda vv, *a: net.apply(vv, *a, method=net.convert))(
                v, wav, f0, tid)]
            got = [model.convert(x, torch.from_numpy(f0), torch.from_numpy(tid))]
        elif name.startswith("asv_xvector"):
            (_, ref_logits), ref_xv = jax.jit(lambda vv, w: net.apply(vv, w, train=False))(v, wav)
            (_, logits), xv = model(x)
            a, b = xv.numpy(), np.asarray(ref_xv)
            cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
            assert cos.min() >= 0.9999, cos
            ref, got = [ref_logits], [logits]
        else:
            ref = jax.jit(lambda vv, w: net.apply(vv, w))(v, wav)[:2]
            got = model(x)[:2]
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert rel_err(g.numpy(), np.asarray(r)) <= 1e-4


def test_reader_needs_no_msgpack_or_flax(satpu_checkpoints, tmp_path):
    """A process where ``import msgpack`` / ``import flax`` fail reads every
    satpu checkpoint into the same state_dict as this one."""
    from satpu_torch import infer_helper

    out = str(tmp_path / "sds.pt")
    code = ("import sys, torch\n"
            "for m in ('msgpack', 'flax', 'jax', 'satpu'): sys.modules[m] = None\n"
            "from satpu_torch import infer_helper\n"
            f"paths = {[satpu_checkpoints[n][0] for n in CASES]!r}\n"
            "sds = {p: infer_helper.read_checkpoint(p)[1] for p in paths}\n"
            "m, _ = infer_helper.load_model(paths[3], device='cpu')\n"
            "assert m.cfg.frontend == 'wavlm'\n"
            f"torch.save(sds, {out!r})\n"
            "bad = [k for k, v in sys.modules.items() if v is not None and k.split('.')[0] in "
            "('msgpack', 'flax', 'jax')]\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    sds = torch.load(out)
    for name in CASES:
        path = satpu_checkpoints[name][0]
        want = infer_helper.read_checkpoint(path)[1]
        assert sorted(sds[path]) == sorted(want), name
        assert all(torch.equal(sds[path][k], want[k]) for k in want), name


def test_satpu_anonymizer_without_heads_loads(satpu_checkpoints):
    """satpu creates parameters as its modules run: an anonymizer initialized
    through ``convert`` has no chain / xent heads and no after-BN stage. The
    port loads what the checkpoint holds and keeps its own init for those."""
    from satpu_torch import infer_helper

    path = satpu_checkpoints["anonymizer_tdnnf_hifigan"][0]
    _, sd = infer_helper.read_checkpoint(path)
    model, _ = infer_helper.load_model(path, device="cpu")
    absent = set(model.state_dict()) - set(sd)
    assert absent and all(k.startswith("bn_extractor.") for k in absent)
    assert not any(k.startswith("bn_extractor.tdnnfs.0.") for k in absent)
    for k, t in sd.items():
        assert torch.equal(model.state_dict()[k], t), k


def test_wavlm_build_params_round_trip(tmp_path):
    """An ``asv_xvector`` with a WavLM config dict in its build params saves
    and loads as a port checkpoint (satpu's builder cannot take the dict)."""
    from satpu_torch import infer_helper
    from satpu_torch.models.wavlm import WavLMConfig

    params = dict(XV_TINY, frontend="wavlm", wavlm=dataclasses.asdict(WavLMConfig(**WAVLM)))
    model = infer_helper.build_model("asv_xvector", device="cpu", seed=1, **params)
    path = str(tmp_path / "wavlm.pt")
    infer_helper.save_model(path, "asv_xvector", params, model.state_dict())
    loaded, meta = infer_helper.load_model(path, device="cpu")
    assert loaded.cfg.wavlm == meta["build_params"]["wavlm"]
    assert loaded.preprocessor.feature_extract.cfg == WavLMConfig(**WAVLM)
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in model.state_dict().items())
