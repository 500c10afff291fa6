"""``wav2vec2.conv`` 40 and 44 ms of stream time inside two ``wav2vec2.front``
spans, over two recorded steps: 42 ms a step."""
import readercases as rc
from readercases import empty  # noqa: F401

EXPECTED = 42.0


def layer():
    return rc.layer(recorded={"steps": 2, "spans": [
        rc.span("wav2vec2.conv", 40.0), rc.span("wav2vec2.front", 300.0),
        rc.span("wav2vec2.conv", 44.0), rc.span("wav2vec2.front", 340.0)]})
