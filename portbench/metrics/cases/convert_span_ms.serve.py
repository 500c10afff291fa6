"""The one ``convert`` event span: 5 ms."""
from readercases import empty, layer  # noqa: F401

EXPECTED = 5.0
