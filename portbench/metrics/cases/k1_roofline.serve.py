"""K1's bound of 10 us over the trace's 20 us of ``shc_band_kernel``: 50%."""
from readercases import empty, layer  # noqa: F401

EXPECTED = 50.0
