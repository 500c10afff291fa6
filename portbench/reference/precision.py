"""The operand precision of the reference's matmuls and convs.

By default values pass through unchanged. ``lower("fp8")`` rounds to
float8 e4m3, with a per-tensor scale, every value that the serving
configuration holds in bfloat16: the inputs, weights and results of the
extractor's matmuls and the generator's convs, and the generator's
residual sums, as an fp8 pipeline would hold them. ``lower("tf32")`` lets
the card's matmuls and cuDNN convs run in TF32. These are the controls,
each one step below the precision that a configuration states."""
from __future__ import annotations

import contextlib
import contextvars

import torch

_KIND: contextvars.ContextVar = contextvars.ContextVar("portbench_operand", default=None)
E4M3_MAX = 448.0


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale, back in t's dtype."""
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / E4M3_MAX
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)


def operand(t: torch.Tensor) -> torch.Tensor:
    return fp8_round(t) if _KIND.get() == "fp8" and t.is_floating_point() else t


@contextlib.contextmanager
def lower(kind):
    """Run the block in the precision ``kind``: None, "fp8" or "tf32"."""
    if kind not in (None, "fp8", "tf32"):
        raise ValueError(f"unknown precision {kind!r}")
    token = _KIND.set(kind)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    tf32 = kind == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        _KIND.reset(token)
