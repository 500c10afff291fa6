"""Weights made on the card from the seed, in one draw, and handed alike to
the program and to the reference."""
from __future__ import annotations

import math
from typing import Dict


def draw(torch, model, seed: int, device) -> Dict[str, "torch.Tensor"]:
    """A new value for every floating tensor of ``model.state_dict()``, from
    one uniform draw of a card generator seeded with ``seed``: each tensor
    keeps the spread that the model's own initialisation gives it, about
    the same mean, except a bias, which is drawn about zero (a constant
    tensor, such as a norm's running variance, stays as it is). The port's
    conv biases start uniform in [0, 2 / sqrt(fan_in)]; kept so, the
    generator's one output channel would carry a DC offset of up to 0.19
    under a waveform of 1e-3, finer than one bfloat16 step of the offset.
    The model is not changed."""
    state = model.state_dict()
    names = [k for k, v in state.items() if v.is_floating_point()]
    moments = torch.stack([torch.stack([state[k].float().mean(),
                                        state[k].float().std(unbiased=False)])
                           for k in names]).cpu()
    total = sum(state[k].numel() for k in names)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32) * 2 - 1
    out, at = dict(state), 0
    for k, (mean, std) in zip(names, moments.tolist()):
        v = state[k]
        n = v.numel()
        if k.endswith("bias"):
            mean = 0.0
        if std > 0:
            # uniform with this mean and the init's standard deviation
            out[k] = (mean + math.sqrt(3) * std * flat[at:at + n]).view(v.shape).to(v.dtype)
        else:
            out[k] = torch.full_like(v, mean) if k.endswith("bias") else v.detach().clone()
        at += n
    return out


def calibrate(torch, extractor, wav, seed: int) -> Dict[str, "torch.Tensor"]:
    """The extractor's batch-norm running statistics and VQ codebook, set
    from one pass of ``extractor.extract_bn`` (the plain reference's
    TDNN-F, in eval mode) over ``wav``: each batch norm takes the mean and
    variance of its own input over the batch's frames, before it
    normalises with them, and the codebook takes the centroids of its input
    frames (``kmeans``, seeded from ``seed``), as a trained codebook would
    be. Drawn weights leave the statistics at 0 and 1, under which the
    biases dominate and the quantizer picks one code for every frame, so
    the waveform would not depend on the extractor at all.
    Returns the changed buffers by their names in ``extractor``'s
    ``state_dict``."""
    gen = torch.Generator(device=wav.device).manual_seed(seed)

    def norm_stats(mod, inp):
        x = inp[0].float()
        var, mean = torch.var_mean(x, dim=(0, 2), unbiased=False)
        mod.running_mean.copy_(mean)
        mod.running_var.copy_(var)

    def codebook(mod, inp):
        x = inp[0].float()
        mod.embedding.copy_(kmeans(torch, x.transpose(1, 2).reshape(-1, x.shape[1]),
                                   mod.embedding.shape[0], gen))

    hooks = [m.register_forward_pre_hook(norm_stats if hasattr(m, "running_var") else codebook)
             for m in extractor.modules()
             if hasattr(m, "running_var") or type(m).__name__ == "VectorQuantizerEMA"]
    try:
        with torch.no_grad():
            extractor.eval().extract_bn(wav)
    finally:
        for h in hooks:
            h.remove()
    return {k: v.detach().clone() for k, v in extractor.state_dict().items()
            if k.endswith(("running_mean", "running_var", "vq.embedding"))}


def kmeans(torch, x, k: int, gen, iters: int = 10):
    """``k`` centroids of the rows of ``x``: k-means++ seeds drawn with
    ``gen``, then ``iters`` Lloyd steps (sums by a one-hot product, so a
    seed gives the same centroids every run; an empty cluster keeps its
    centroid)."""
    centers = x[torch.randint(x.shape[0], (1,), generator=gen, device=x.device)]
    d2 = ((x - centers[0]) ** 2).sum(1)
    for _ in range(1, k):
        p = d2 if float(d2.sum()) > 0 else torch.ones_like(d2)
        i = torch.multinomial(p, 1, generator=gen)
        centers = torch.cat([centers, x[i]])
        d2 = torch.minimum(d2, ((x - x[i]) ** 2).sum(1))
    for _ in range(iters):
        dist = (x ** 2).sum(1, keepdim=True) - 2 * x @ centers.T + (centers ** 2).sum(1)
        onehot = torch.nn.functional.one_hot(dist.argmin(1), k).to(x.dtype)
        count = onehot.sum(0)[:, None]
        centers = torch.where(count > 0, (onehot.T @ x) / count.clamp(min=1), centers)
    return centers
