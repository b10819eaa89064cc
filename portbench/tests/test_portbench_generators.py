"""The traffic generator and the fit's start are functions of the seed."""

import numpy as np
import pytest

from portbench import drivers, harness
from portbench.orbit import Orbit

SEEDS = (0, 1, 2**31 + 7, 2**33 + 5)


@pytest.mark.parametrize("config", ["bunny_standin", "gvt_simple"])
@pytest.mark.parametrize("mix", ["resident_orbit", "api_orbit"])
def test_orbit_is_the_seeds(config, mix):
    cfg = harness.load_json(harness.HERE / "configs" / f"{config}.json")
    traffic = harness.load_json(harness.HERE / "traffic" / f"{mix}.json")
    bounds = drivers.scene_bounds(harness.scene_of(cfg))
    n = 200
    runs = {s: [Orbit(cfg, traffic, s, bounds).pose(k) for k in range(n)]
            for s in SEEDS}
    for s in SEEDS:
        assert [Orbit(cfg, traffic, s, bounds).pose(k)
                for k in range(n)] == runs[s]
    assert runs[SEEDS[0]] != runs[SEEDS[1]]
    lo, hi = bounds
    center = np.asarray(cfg["orbit"]["center"])
    means = []
    for poses in runs.values():
        eyes = np.asarray([p[0] for p in poses])
        # every eye outside the scene's box
        assert np.all(np.any((eyes < lo) | (eyes > hi), axis=1))
        rel = eyes - center
        dist = np.linalg.norm(rel, axis=1)
        el = np.degrees(np.arcsin(rel[:, 1] / dist))
        means.append((np.mean(dist), np.mean(el)))
    # any seed's first frames cover the same poses evenly
    means = np.asarray(means)
    assert np.ptp(means[:, 0]) < 0.02 * np.mean(means[:, 0])
    assert np.ptp(means[:, 1]) < 1.5


def test_views_and_fit_start_are_the_seeds(small_cell):
    cell = small_cell("gvt_simple.train")
    a = drivers.make(cell, 11, "cpu", (16, 16))
    b = drivers.make(cell, 11, "cpu", (16, 16))
    c = drivers.make(cell, 12, "cpu", (16, 16))
    assert a.views == b.views and a.views != c.views
    assert np.array_equal(a.light_factor, b.light_factor)
    assert np.array_equal(a.kd_factor, b.kd_factor)
    assert not np.array_equal(a.kd_factor, c.kd_factor)
    lo, hi = cell.traffic["perturb"]["kd"]
    assert np.all((a.kd_factor >= lo) & (a.kd_factor <= hi))
    assert len(a.views) == cell.traffic["views"]["count"]
