"""Tokens generated in the measured window (every prefill's first token
and every decode row's token) over the window's seconds (host clock)."""


def read(run):
    w = run["window"]
    return w.tokens / w.seconds
