"""``chain.net_forward`` 0.1 + 0.05 and ``chain.net_backward`` 0.05 ms over two
timed steps: 0.1 ms a step."""
from readercases import empty, layer  # noqa: F401

EXPECTED = 0.1
