"""Shared inputs and measures for the satpu_torch parity tests
(tests/test_torch_*.py): seeded synthetic signals, tiny model configs, and
the relative-error measure every tolerance is stated in."""
import numpy as np

FS = 16000

# tiny ASR-BN (VQ bottleneck, like the flagship) and generator widths
ASRBN_TINY = dict(output_dim=16, hidden_dim=32, bottleneck_dim=16,
                  prefinal_bottleneck_dim=16, bottleneck="vq", codebook_size=8)
ANON_TINY = dict(num_speakers=3, bn_dim=16, upsample_initial_channel=32)
# tiny ECAPA x-vector (24 mels: the ResNet's pooling needs n_mels % 8 == 0)
XV_TINY = dict(num_speakers=10, n_mels=24, channels=32, embedding_size=16)


def rel_err(out, ref) -> float:
    """max |out - ref| / max |ref|."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30))


def harmonic(T, f0, seed, amp=0.3, vibrato=0.02, noise=0.001, fs=FS):
    """Voiced harmonic signal with vibrato around ``f0`` plus a noise floor;
    returns (signal float32, instantaneous f0 per sample)."""
    r = np.random.default_rng(seed)
    t = np.arange(T) / fs
    f = f0 * (1 + vibrato * np.sin(2 * np.pi * 3.5 * t))
    phase = 2 * np.pi * np.cumsum(f) / fs
    s = sum(a * np.sin(h * phase) for h, a in [(1, 1.0), (2, 0.55), (3, 0.35), (4, 0.18)])
    env = np.minimum(1, np.minimum(np.arange(T) / 300, (T - np.arange(T)) / 300))
    s = s * amp * env + r.standard_normal(T) * noise
    return s.astype(np.float32), f


def yaapt_batch_signals(T=FS):
    """Four 1 s signals: three voiced (low, mid, high F0, one noisy) and one
    unvoiced (white noise)."""
    a, _ = harmonic(T, 110.0, seed=1)
    b, _ = harmonic(T, 190.0, seed=2)
    c, _ = harmonic(T, 290.0, seed=3, noise=0.02)
    d = (np.random.default_rng(4).standard_normal(T) * 0.05).astype(np.float32)
    return np.stack([a, b, c, d])


def jax_variables_numpy(variables):
    """flax variables -> nested dicts of writable numpy arrays."""
    if hasattr(variables, "items"):
        return {k: jax_variables_numpy(v) for k, v in variables.items()}
    return np.array(variables)


def randomize_bn(variables, seed=0):
    """numpy variables with non-trivial batch norms, in place: every
    batch_stats mean ~ N(0, 0.1) and var ~ U(0.5, 2), and every constant
    params leaf (a fresh norm's ones / zeros) moved by N(0, 0.1). A
    mis-mapped batch norm then shows."""
    r = np.random.default_rng(seed)

    def walk(tree, fn):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, fn)
            else:
                tree[k] = fn(k, v)

    walk(variables.get("batch_stats", {}), lambda k, v: (
        r.normal(0.0, 0.1, v.shape) if k == "mean" else r.uniform(0.5, 2.0, v.shape)
    ).astype(np.float32))
    walk(variables.get("params", {}), lambda k, v: (
        v + r.normal(0.0, 0.1, v.shape).astype(np.float32) if np.ptp(v) == 0 else v))
    return variables


def satpu_init(module, *args, seed=0, **kw):
    """satpu module.init (jitted) -> numpy variables with randomized batch
    norms."""
    import jax

    init = jax.jit(lambda key, *a: module.init(key, *a, **kw))
    return randomize_bn(jax_variables_numpy(init(jax.random.PRNGKey(seed), *args)), seed)


def satpu_apply(module, variables, *args, **kw):
    """satpu module.apply, jitted (one compile instead of op-by-op dispatch)."""
    import jax

    return jax.jit(lambda v, *a: module.apply(v, *a, **kw))(variables, *args)


def bridged(module, variables):
    """The port's ``module`` in eval mode with satpu's x-vector ``variables``
    carried across; the bridge must fill every tensor."""
    from satpu_torch.models.convert import from_satpu_xvector

    sd = from_satpu_xvector(variables)
    assert set(sd) == set(module.state_dict()), set(sd) ^ set(module.state_dict())
    module.load_state_dict(sd)
    return module.eval()


def satpu_xvector(seed=0, **kw):
    """(satpu model, its randomized numpy variables, the port's model with
    them) for an x-vector config."""
    from satpu.sidekit.xvector import XVectorConfig as JCfg
    from satpu.sidekit.xvector import build_xvector as jbuild
    from satpu_torch.sidekit.xvector import XVectorConfig, build_xvector

    jm = jbuild(JCfg(**kw))
    v = satpu_init(jm, np.zeros((1, 8000), np.float32), train=False, seed=seed)
    return jm, v, bridged(build_xvector(XVectorConfig(**kw)), v)
