"""Device milliseconds a group in the rank stage: the summed device
intervals (first launch's start to last's end) of the program's
`sam_audio.rank` spans (SAMAudio._choose: the ranker's scoring of every
candidate, the argmax, the winners' copy) in the traced window, over the
traced groups (portbench/harness/spans.py). The span's host wall is not
read: the argmax waits there for the target decode queued before it, so
the wall counts the decode's device time too. None where the program opens
no such span."""

from portbench.harness import spans


def read(ctx):
    sp = spans.reduce(ctx)
    if sp is None or not ctx["groups"]:
        return None
    device = sp.device("rank")
    if not device:
        return None
    return spans.length(device) / 1e6 / ctx["groups"]
