"""``chain.num_forward`` and ``chain.xent_posteriors`` recorded over two
steps, (2 + 0.5 + 2.4 + 0.6) / 2 ms; the den's and the phases' spans are
not counted."""
import readercases as rc
from readercases import empty  # noqa: F401

EXPECTED = 2.75


def layer():
    return rc.layer(recorded={"steps": 2, "spans": [
        rc.span("chain.num_forward", 2.0), rc.span("chain.xent_posteriors", 0.5),
        rc.span("chain.den_forward", 4.0), rc.span("chain.objective_forward", 7.0),
        rc.span("chain.num_forward", 2.4), rc.span("chain.xent_posteriors", 0.6),
        rc.span("chain.den_backward", 3.0)]})
