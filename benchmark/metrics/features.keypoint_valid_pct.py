"""Share of FeatureReg's keypoint rows that hold a keypoint, in percent:
the valid rows over the rows kept (a fixed ``min(1e6 // tiles, 5000)`` a
tile, which FAST's top-k, DAISY, the knn and RANSAC all run over), from
the port's ``features.keypoints`` counters (``find_features_tiled``),
summed over the window; nothing where the port records no such counter."""

from benchmark import program_trace


def read(t):
    records = program_trace.counters(t, "features.keypoints")
    rows = sum(int(c.values["rows"]) for c in records)
    if not rows:
        return None
    return 100.0 * sum(int(c.values["valid"]) for c in records) / rows
