"""*Random Access* workload generator — faithful to paper Algorithm 2.

    while True:
        load_type   <- Random([light, medium, heavy])
        request_num <- Random(Range(20, 200))
        for i in 0..request_num:
            task <- Random([sort]*9 + [eigen])     # 0.9 / 0.1
            Request(task)
            sleep <- Range(0.1,0.3) heavy | Range(0.5,1) medium | Range(2,5) light
            Sleep(Random(sleep))

Sort tasks are served at the generating edge zone; Eigen tasks are forwarded
to the cloud (paper §5.1.2).  One generator per edge zone.
"""
from __future__ import annotations

import numpy as np

SLEEP_RANGES = {"heavy": (0.1, 0.3), "medium": (0.5, 1.0), "light": (2.0, 5.0)}


def random_access(t_end: float, zones: list[str] | None = None,
                  seed: int = 0) -> list[tuple[float, str, str]]:
    """Returns sorted [(arrival_t, kind, serving_zone)]."""
    zones = zones or ["edge-0", "edge-1"]
    rng = np.random.default_rng(seed)
    tasks: list[tuple[float, str, str]] = []
    for zone in zones:
        t = 0.0
        while t < t_end:
            load = rng.choice(["light", "medium", "heavy"])
            lo, hi = SLEEP_RANGES[load]
            n = int(rng.integers(20, 200))
            for _ in range(n):
                kind = "eigen" if rng.random() < 0.1 else "sort"
                serve_zone = "cloud" if kind == "eigen" else zone
                tasks.append((t, kind, serve_zone))
                t += float(rng.uniform(lo, hi))
                if t >= t_end:
                    break
    tasks.sort(key=lambda x: x[0])
    return tasks
