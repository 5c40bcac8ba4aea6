"""Seconds of input audio whose target and residual came back, over the
wall seconds of the window (host clock; the window closes at the first call
that ends past --seconds, so no call is counted in part)."""


def read(ctx):
    return ctx["audio_s"] / ctx["window_s"]
