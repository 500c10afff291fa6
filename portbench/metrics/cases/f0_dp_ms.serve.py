"""The DPs' recorded spans over two batches, (10 + 5 + 12 + 3) / 2 ms;
another stage's span and a DP span without events are not counted."""
import readercases as rc
from readercases import empty  # noqa: F401

EXPECTED = 15.0


def layer():
    return rc.layer(recorded={"steps": 2, "spans": [
        rc.span("yaapt.dynamic5", 10.0), rc.span("yaapt.dynamic_final", 5.0),
        rc.span("yaapt.nlfer", 50.0), rc.span("yaapt.dynamic5", 12.0),
        rc.span("yaapt.dynamic_final", 3.0), rc.span("yaapt.dynamic5", None)]})
