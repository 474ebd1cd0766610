"""Seconds a cycle in FeatureReg's knn and ratio test
(``features/match.py``): the port's own ``[profile] feature lvlN match``
lines (``MICROALIGNER_TPU_PROFILE=1``, on in the traced run), summed over
the window and divided by its cycles; nothing where no such line came."""

import re

LINE = re.compile(r"^\[profile\] feature lvl\d+ match: ([0-9.]+)s$", re.M)


def read(t):
    found = [float(s) for s in LINE.findall(t.log)]
    return sum(found) / t.cycles if found else None
