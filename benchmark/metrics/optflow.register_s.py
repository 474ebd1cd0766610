"""Seconds a cycle in ``OptFlowRegistrator.register_device``: the
benchmark's synchronised span around the call, mean over the window's
cycles."""


def read(t):
    n = t.spans.count("optflow.register")
    return t.spans.total("optflow.register") / n if n else None
