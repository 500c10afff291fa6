"""``chain.objective_forward`` 0.3 and ``chain.objective_backward`` 0.1 ms over
two timed steps: 0.2 ms a step."""
from readercases import empty, layer  # noqa: F401

EXPECTED = 0.2
