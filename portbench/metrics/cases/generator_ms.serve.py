"""``anon.generator`` recorded over two batches, (80 + 90) / 2 ms; the
extractor's span and a span without events are not counted."""
import readercases as rc
from readercases import empty  # noqa: F401

EXPECTED = 85.0


def layer():
    return rc.layer(recorded={"steps": 2, "spans": [
        rc.span("anon.extractor", 8.0), rc.span("anon.generator", 80.0),
        rc.span("anon.generator", 90.0), rc.span("anon.generator", None)]})
