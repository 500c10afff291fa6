"""Busy 235 us of the trace for 1 ms of audio, at 2 audio-s/s untraced:
1 - 235e-6 / 1e-3 x 2 = 53%."""
from readercases import empty, layer  # noqa: F401

EXPECTED = 53.0
