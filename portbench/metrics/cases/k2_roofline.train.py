"""K2's bound of 25 us over the trace's 50 + 50 us of ``den_fwd`` and
``den_bwd``: 25%."""
from readercases import empty, layer  # noqa: F401

EXPECTED = 25.0
