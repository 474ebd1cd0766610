"""Seconds a cycle in ``FeatureRegistrator.register``: the benchmark's
synchronised span around the call, mean over the window's cycles; nothing
where the configuration has no FeatureReg."""


def read(t):
    n = t.spans.count("features.register")
    return t.spans.total("features.register") / n if n else None
