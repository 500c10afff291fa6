"""The card's idle share, in %: its busy seconds an audio-second over the
traced pass over the corpus (the union of its items' intervals) times the
audio-seconds a second of the untraced stretch (``trace.idle_percent``)."""
from portbench.trace import idle_percent


def read(layer):
    return idle_percent(layer)
