"""The one traffic generator: camera poses from a mix's parameters, the
configuration's orbit and the seed.

Frame k of an orbit takes the k-th point of Roberts' R3 low-discrepancy
sequence (x_k = frac(s + k * alpha), alpha = (1/g, 1/g^2, 1/g^3), g the
real root of x^4 = x + 1), shifted by s, three uniforms drawn from the
seed: azimuth over the whole circle, elevation and distance uniform over
their ranges. Any run of consecutive frames covers the pose space evenly,
so a window does the same work on every seed and at every length; a seed
only turns the sequence (a seeded random walk would let the seed decide
which poses a window covers).
"""

from __future__ import annotations

import math

import numpy as np

_G = 1.2207440846057596        # x**4 == x + 1
ALPHA = np.array([1.0 / _G, 1.0 / _G ** 2, 1.0 / _G ** 3])


def _push_out(center, direction, dist, lo, hi):
    """The distance along `direction` from `center` at which the eye
    leaves the box [lo, hi], if it lies inside it at `dist`."""
    eye = center + direction * dist
    if np.any(eye < lo) or np.any(eye > hi):
        return dist
    exits = [((hi[a] if direction[a] > 0 else lo[a]) - center[a])
             / direction[a] for a in range(3) if abs(direction[a]) > 1e-12]
    return max(dist, min(exits) * 1.0001)


class Orbit:
    """pose(k) -> (eye, focus, up) of frame k. The mix's "orbit" gives
    `elevation_deg` [lo, hi]; the configuration's "orbit" gives `center`
    (the focus), `distance` and `distance_scale` [lo, hi]. `bounds` (lo,
    hi) is the scene's box, grown by 2% of its diagonal: an eye inside it
    moves out along its direction (a viewer stays outside the model)."""

    def __init__(self, config: dict, mix: dict, seed: int, bounds=None):
        rng = np.random.default_rng(seed)
        self.shift = rng.random(3)
        co = config["orbit"]
        self.center = np.asarray(co["center"], np.float64)
        self.dist = (co["distance"] * co["distance_scale"][0],
                     co["distance"] * co["distance_scale"][1])
        self.elev = np.radians(mix["orbit"]["elevation_deg"])
        self.up = tuple(float(x) for x in config["camera"]["up"])
        self.bounds = None
        if bounds is not None:
            lo, hi = (np.asarray(b, np.float64) for b in bounds)
            grow = 0.02 * np.linalg.norm(hi - lo)
            self.bounds = (lo - grow, hi + grow)

    def pose(self, k: int) -> tuple:
        x = np.modf(self.shift + k * ALPHA)[0]
        az = 2.0 * math.pi * x[0]
        el = self.elev[0] + (self.elev[1] - self.elev[0]) * x[1]
        d = self.dist[0] + (self.dist[1] - self.dist[0]) * x[2]
        direction = np.array([math.cos(el) * math.sin(az), math.sin(el),
                              math.cos(el) * math.cos(az)])
        if self.bounds is not None:
            d = _push_out(self.center, direction, d, *self.bounds)
        eye = self.center + direction * d
        return (tuple(float(v) for v in eye),
                tuple(float(v) for v in self.center), self.up)


def stratified(rng: np.random.Generator, lo: float, hi: float,
               n: int) -> np.ndarray:
    """n values, one in each of n equal slices of [lo, hi), in a seeded
    order."""
    u = (np.arange(n) + rng.random(n)) / n
    rng.shuffle(u)
    return lo + (hi - lo) * u


def view_poses(config: dict, mix: dict, seed: int) -> list:
    """[(eye, focus, up)] of the fit's views: the configuration's camera
    turned about the orbit's centre by stratified offsets (the mix's
    "views": `count`, `azimuth_deg`, `elevation_deg`, `distance_scale`)."""
    rng = np.random.default_rng(seed)
    vo = mix["views"]
    n = int(vo["count"])
    center = np.asarray(config["orbit"]["center"], np.float64)
    eye0 = np.asarray(config["camera"]["eye"], np.float64) - center
    r0 = float(np.linalg.norm(eye0))
    az0 = math.atan2(eye0[0], eye0[2])
    el0 = math.asin(eye0[1] / r0)
    az = az0 + np.radians(stratified(rng, *vo["azimuth_deg"], n))
    el = el0 + np.radians(stratified(rng, *vo["elevation_deg"], n))
    dist = r0 * stratified(rng, *vo["distance_scale"], n)
    up = tuple(float(x) for x in config["camera"]["up"])
    return [(tuple(float(x) for x in center + d * np.array(
        [math.cos(e) * math.sin(a), math.sin(e), math.cos(e) * math.cos(a)])),
        tuple(float(x) for x in center), up)
        for a, e, d in zip(az, el, dist)]
