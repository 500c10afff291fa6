"""The mean of the benchmark's two ``load`` host spans: (1 + 3) / 2 ms."""
from readercases import empty, layer  # noqa: F401

EXPECTED = 2.0
