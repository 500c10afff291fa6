"""``anon.extractor`` recorded over two batches, (8 + 10) / 2 ms; the
generator's span is not counted."""
import readercases as rc
from readercases import empty  # noqa: F401

EXPECTED = 9.0


def layer():
    return rc.layer(recorded={"steps": 2, "spans": [
        rc.span("asrbn.tdnnf", 6.0), rc.span("anon.extractor", 8.0),
        rc.span("anon.generator", 80.0), rc.span("anon.extractor", 10.0)]})
