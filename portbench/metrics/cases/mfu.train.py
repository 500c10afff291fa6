"""The layer's MFU of 0.125: 12.5%."""
from readercases import empty, layer  # noqa: F401

EXPECTED = 12.5
