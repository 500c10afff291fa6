"""``chain.den_forward`` and ``chain.den_backward`` recorded over two
steps, (2.5 + 3 + 2.7 + 3.2) / 2 ms; the numerator's spans are not
counted."""
import readercases as rc
from readercases import empty  # noqa: F401

EXPECTED = 5.7


def layer():
    return rc.layer(recorded={"steps": 2, "spans": [
        rc.span("chain.den_forward", 2.5), rc.span("chain.num_forward", 2.0),
        rc.span("chain.den_backward", 3.0), rc.span("chain.den_forward", 2.7),
        rc.span("chain.den_backward", 3.2)]})
