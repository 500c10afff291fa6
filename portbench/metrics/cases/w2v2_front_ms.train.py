"""``wav2vec2.front`` 300 and 340 ms of stream time, and a ``wav2vec2.conv`` inside
each that is not counted twice, over two recorded steps: 320 ms a step."""
import readercases as rc
from readercases import empty  # noqa: F401

EXPECTED = 320.0


def layer():
    return rc.layer(recorded={"steps": 2, "spans": [
        rc.span("wav2vec2.conv", 40.0), rc.span("wav2vec2.front", 300.0),
        rc.span("wav2vec2.conv", 44.0), rc.span("wav2vec2.front", 340.0),
        rc.span("wav2vec2.front", None)]})
