"""Host milliseconds a group in the offline pipeline's own stages
(SeparationPipeline.timer: host_decode, reading and resampling the requests'
audio, and preprocess, the processor's batch), over the traced window."""


def read(ctx):
    s = ctx["stages"]
    if not ctx["groups"]:
        return None
    return 1e3 * (s.get("host_decode", 0.0) + s.get("preprocess", 0.0)) / ctx["groups"]
