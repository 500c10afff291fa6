"""The mean of the benchmark's two ``get_f0`` event spans: (2 + 4) / 2 ms."""
from readercases import empty, layer  # noqa: F401

EXPECTED = 3.0
