"""The benchmark harness's own CPU cases (``portbench/tests/``) in tier-1:
its readers and their cases, the trace digest, the discovery of new files,
the counts, the traffic, the planted faults that a run must read as not
correct, the import hygiene, and the B5 cell's job. Each module is
collected here as it stands; the card-only cases
(``test_portbench_control.py``) run on the card alone:

    python -m pytest --noconftest -m gpu portbench/tests -q
"""
import os
import sys

HERE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "portbench", "tests")
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from test_portbench_counts import *  # noqa: E402,F401,F403
from test_portbench_discovery import *  # noqa: E402,F401,F403
from test_portbench_faults import *  # noqa: E402,F401,F403
from test_portbench_hygiene import *  # noqa: E402,F401,F403
from test_portbench_readers import *  # noqa: E402,F401,F403
from test_portbench_traffic import *  # noqa: E402,F401,F403
from test_portbench_w2v2 import *  # noqa: E402,F401,F403
