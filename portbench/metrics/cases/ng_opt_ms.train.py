"""``chain.ng`` 0.06 and ``chain.optimizer`` 0.04 ms over two timed steps: 0.05
ms a step."""
from readercases import empty, layer  # noqa: F401

EXPECTED = 0.05
