"""The ASV batch norm's global-batch moments under a process group
(``sidekit.nn.BatchNorm._global_batch_norm``) on inputs whose mean is far
above their spread, |mean|/std = 1e2 and 1e4: one and two gloo ranks on the
CPU (``torch_dp_worker``) against f64, against the no-group path
(``F.batch_norm``) and against satpu's ``torchlayers.BatchNorm`` in
training. The moments are taken in two passes, as ``jnp.var`` takes them;
the one-pass E[x^2] - E[x]^2 in f32 lost the variance (28.6 of the output's
largest entry at 1e4).

Bounds: the output and the gradients (input, weight, bias) within 4x the
no-group error against f64 on the same input, the output also within 1e-3
of its largest entry against f64 and against satpu's (whose own f32 error
at 1e4 is about 4x the no-group path's: its mean's f32 sum); the running
mean and variance rel 1e-5 of satpu's and of f64's."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_dp_worker as W
from torch_parity import rel_err

SHAPE = (64, 16, 200)  # [B, C, T]: 12,800 values a channel
CASES = ((10.0, 0.1), (1000.0, 0.1))  # (mean, std): 1e2 and 1e4
KEYS = ("y", "dx", "dweight", "dbias")


def _inputs():
    runs = []
    for i, (off, sd) in enumerate(CASES):
        r = np.random.default_rng(20 + i)
        runs.append({"x": (off + sd * r.standard_normal(SHAPE)).astype(np.float32),
                     "g": r.standard_normal(SHAPE).astype(np.float32),
                     "weight": (1 + 0.1 * r.standard_normal(SHAPE[1])).astype(np.float32),
                     "bias": (0.1 * r.standard_normal(SHAPE[1])).astype(np.float32)})
    return runs


def _as64(run):
    return {k: v.astype(np.float64) for k, v in run.items()}


def _satpu(run):
    """satpu's BatchNorm in training (channels-last): output, gradients and
    the updated running statistics."""
    from satpu.models.torchlayers import BatchNorm

    bn = BatchNorm(SHAPE[1])
    x = np.ascontiguousarray(run["x"].transpose(0, 2, 1))
    g = np.ascontiguousarray(run["g"].transpose(0, 2, 1))
    v = bn.init(jax.random.PRNGKey(0), x)
    params = {"weight": jnp.asarray(run["weight"]), "bias": jnp.asarray(run["bias"])}

    def f(p, x):
        y, upd = bn.apply({"params": p, "batch_stats": v["batch_stats"]}, x, train=True,
                          mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd["batch_stats"])

    (_, (y, stats)), (dp, dx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, x)
    return {"y": np.asarray(y).transpose(0, 2, 1), "dx": np.asarray(dx).transpose(0, 2, 1),
            "dweight": np.asarray(dp["weight"]), "dbias": np.asarray(dp["bias"]),
            "running_mean": np.asarray(stats["mean"]), "running_var": np.asarray(stats["var"])}


def _gathered(outs):
    """The ranks' results as the global batch's: outputs and input gradients
    concatenated, parameter gradients summed, running statistics rank 0's
    (every rank's the same)."""
    for o in outs[1:]:
        for k in ("running_mean", "running_var"):
            assert torch.equal(o[k], outs[0][k]), k
    return {"y": torch.cat([o["y"] for o in outs]).numpy(),
            "dx": torch.cat([o["dx"] for o in outs]).numpy(),
            "dweight": sum(o["dweight"] for o in outs).numpy(),
            "dbias": sum(o["dbias"] for o in outs).numpy(),
            "running_mean": outs[0]["running_mean"].numpy(),
            "running_var": outs[0]["running_var"].numpy()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{world: [result per case]} for one and two gloo ranks, and the
    no-group f32 / f64 and satpu runs in this process."""
    runs = _inputs()
    out = {}
    for world in (1, 2):
        d = tmp_path_factory.mktemp(f"bn{world}")
        torch.save(runs, str(d / "inputs.pt"))
        ranks = W.spawn("bn", world, str(d), timeout=120)
        out[world] = [_gathered([r[i] for r in ranks]) for i in range(len(runs))]
    n = torch.get_num_threads()
    try:
        out["none"] = [_gathered([W.run_bn(run)]) for run in runs]
        out["f64"] = [_gathered([W.run_bn(_as64(run))]) for run in runs]
    finally:
        torch.set_num_threads(n)
    out["satpu"] = [_satpu(run) for run in runs]
    return out


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("case", range(len(CASES)), ids=["1e2", "1e4"])
def test_global_batch_norm_is_two_pass(results, world, case):
    got, f64 = results[world][case], results["f64"][case]
    none, satpu = results["none"][case], results["satpu"][case]
    err = {k: rel_err(got[k], f64[k]) for k in KEYS}
    base = {k: rel_err(none[k], f64[k]) for k in KEYS}
    for k in KEYS:
        assert err[k] <= 4 * base[k], (k, err, base)
    assert err["y"] <= 1e-3, err
    assert rel_err(got["y"], satpu["y"]) <= 1e-3, rel_err(got["y"], satpu["y"])
    for k in ("running_mean", "running_var"):
        assert rel_err(got[k], satpu[k]) <= 1e-5, (k, rel_err(got[k], satpu[k]))
        assert rel_err(got[k], f64[k]) <= 1e-5, (k, rel_err(got[k], f64[k]))
