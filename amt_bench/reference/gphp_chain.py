"""Plain reference of the engine's GPHP refit: the slice chain of paper
§4.2 over the packed GPHP posterior, in NumPy, replayed on the draws the
job's seed determines.

Written from the paper and the engine's documented semantics; it imports
nothing of the program:

  * the packed vector z = (log ℓ (d), log amplitude, log noise std,
    log a (d), log b (d)) under the box bounds of the stability limits
    (ℓ in [0.01, 30], amplitude in [0.05, 20], noise std in [1e-4, 1],
    Kumaraswamy shapes in [1/4, 4]); the target is the log marginal
    likelihood of the z-scored targets under the warped Matérn-5/2 ARD gram
    (noise² plus a 1e-8 jitter on the diagonal) plus a Gaussian prior
    centred mid-box with a quarter of the box's width as its std; −inf
    outside the box, NaN where the gram does not factorize;
  * Neal's univariate slice sampler along a random unit direction per
    update: level g(0) − Exp(1), a bracket of width 0.5 placed at −0.5·r
    and stepped out at most 8 times a side, then at most 32 shrink points
    max(lo, u·(hi − lo) + lo), staying put when none is accepted; 300
    updates, the 250th, 255th, … kept;
  * the draws: a job seeded ``seed`` holds the threefry key
    ``PRNGKey(seed)`` and splits one subkey off it for every refit and for
    every configuration a GP decision picks, in that order; a chain splits
    its subkey into one key an update, each into four (direction, level,
    offset, shrink keys), the shrink key split again once a shrink point
    (``threefry.py``);
  * a job's first chain starts at unit lengthscales and amplitude, a 1e-2
    noise std and identity warping, clipped 1e-4 inside the box; every
    later chain starts at the last kept sample of the job's previous chain
    (or, for a job whose first draws came from a sibling, at the sibling's).

``dtype`` sets the precision of the whole chain: float64 is the reference,
float32 the lower-precision control.
"""

from __future__ import annotations

import math
from typing import Iterator, Optional

import numpy as np
from scipy.linalg import solve_triangular

from amt_bench.reference import threefry

SQRT5 = math.sqrt(5.0)
LOG2PI = 1.8378770664093453
JITTER = 1e-8
WARP_EPS = 1e-6
STEP = 0.5
MAX_STEPOUT = 8
MAX_SHRINK = 32


def bounds(d: int):
    """(lower, upper) of the packed vector, every input dimension warped."""
    lo = np.concatenate([np.full(d, math.log(0.01)), [math.log(0.05), math.log(1e-4)],
                         np.full(2 * d, math.log(0.25))])
    hi = np.concatenate([np.full(d, math.log(30.0)), [math.log(20.0), math.log(1.0)],
                         np.full(2 * d, math.log(4.0))])
    return lo, hi


def first_start(d: int) -> np.ndarray:
    lo, hi = bounds(d)
    z = np.concatenate([np.zeros(d), [0.0, math.log(1e-2)], np.zeros(2 * d)])
    return np.clip(z, lo + 1e-4, hi - 1e-4)


def clipped_start(z: np.ndarray) -> np.ndarray:
    lo, hi = bounds((len(z) - 2) // 3)
    return np.clip(np.asarray(z, dtype=np.float64), lo + 1e-4, hi - 1e-4)


def job_keys(seed: int) -> Iterator[np.ndarray]:
    """The subkeys a job seeded ``seed`` splits off, in order."""
    key = threefry.PRNGKey(seed)
    while True:
        pair = threefry.split(key)
        key = pair[0]
        yield pair[1]


def draws(key: np.ndarray, dim: int, updates: int):
    """(directions (T, dim), levels (T,), offsets (T,), shrink (T, 32))."""
    keys = threefry.split(key, updates)
    sub = threefry.split_each(keys, 4)
    normals = threefry.normal_each(sub[:, 0], dim)
    directions = np.empty_like(normals)
    for i, row in enumerate(normals):
        directions[i] = row / max(float(np.linalg.norm(row)), 1e-12)
    levels = threefry.exponential_each(sub[:, 1])
    offsets = threefry.unit_uniform_each(sub[:, 2])
    shrink = np.empty((updates, MAX_SHRINK))
    k = sub[:, 3]
    for j in range(MAX_SHRINK):
        pair = threefry.split_each(k)
        k = pair[:, 0]
        shrink[:, j] = threefry.unit_uniform_each(pair[:, 1])
    return directions, levels, offsets, shrink


class LogPosterior:
    """The chain's target over the rows ``x`` (n, d) with z-scored ``y``."""

    def __init__(self, x, y, dtype=np.float64):
        self.dt = dtype
        self.x = np.asarray(x, dtype=dtype)
        self.y = np.asarray(y, dtype=dtype)
        d = self.x.shape[1]
        self.d = d
        lo, hi = bounds(d)
        self.lo, self.hi = lo.astype(dtype), hi.astype(dtype)
        self.center = ((lo + hi) / 2).astype(dtype)
        self.prior_std = np.maximum((hi - lo) / 4.0, 1e-6).astype(dtype)
        self.eye = np.eye(len(self.x), dtype=dtype)

    def __call__(self, z: np.ndarray) -> float:
        dt, d = self.dt, self.d
        z = np.asarray(z, dtype=dt)
        if not (np.all(z >= self.lo) and np.all(z <= self.hi)):
            return -math.inf
        one = dt(1.0)
        a, b = np.exp(z[d + 2:2 * d + 2]), np.exp(z[2 * d + 2:])
        xc = np.clip(self.x, dt(WARP_EPS), one - dt(WARP_EPS))
        xa = np.clip(np.exp(a * np.log(xc)), dt(WARP_EPS), one - dt(WARP_EPS))
        w = one - np.exp(b * np.log1p(-xa))
        ident = (np.abs(z[d + 2:2 * d + 2]) < 1e-7) & (np.abs(z[2 * d + 2:]) < 1e-7)
        w = np.where(ident, self.x, w) * np.exp(-z[:d])
        diff = w[:, None, :] - w[None, :, :]
        r2 = (diff * diff).sum(-1)
        r = np.sqrt(np.maximum(r2, dt(1e-30)))
        amp2 = np.exp(dt(2.0) * z[d])
        k = amp2 * (one + dt(SQRT5) * r + dt(5.0 / 3.0) * r2) * np.exp(-dt(SQRT5) * r)
        k = k + (np.exp(dt(2.0) * z[d + 1]) + dt(JITTER)) * self.eye
        try:
            chol = np.linalg.cholesky(k)
        except np.linalg.LinAlgError:
            return math.nan
        v = solve_triangular(chol, self.y, lower=True)
        quad = v @ v
        logdet = dt(2.0) * np.log(np.diagonal(chol)).sum()
        mll = dt(-0.5) * (quad + logdet + dt(len(self.x)) * dt(LOG2PI))
        prior = dt(-0.5) * (((z - self.center) / self.prior_std) ** 2).sum()
        return float(dt(mll + prior))


def chain(x, y, z0, key, num_samples=300, burn_in=250, thin=5,
          dtype=np.float64, log_prob: Optional[LogPosterior] = None) -> np.ndarray:
    """The kept samples (num_kept, 3d + 2) of one chain, as float64."""
    dt = dtype
    g_of = log_prob if log_prob is not None else LogPosterior(x, y, dt)
    z = np.asarray(z0, dtype=dt)
    directions, levels, offsets, shrink = (np.asarray(a, dtype=dt)
                                           for a in draws(key, len(z), num_samples))
    step = dt(STEP)
    buf = np.zeros((num_samples, len(z)), dtype=dt)
    for i in range(num_samples):
        def g(t):
            return g_of(z + t * directions[i])

        log_y = g(dt(0.0)) - levels[i]
        lo = -step * offsets[i]
        hi = lo + step
        for _ in range(MAX_STEPOUT):
            if not g(lo) > log_y:
                break
            lo = lo - step
        for _ in range(MAX_STEPOUT):
            if not g(hi) > log_y:
                break
            hi = hi + step
        t_fin = dt(0.0)
        for u in shrink[i]:
            t_new = max(lo, u * (hi - lo) + lo)
            if g(t_new) > log_y:
                t_fin = t_new
                break
            if t_new < 0.0:
                lo = t_new
            else:
                hi = t_new
        z = z + t_fin * directions[i]
        buf[i] = z
    num_kept = max(1, (num_samples - burn_in) // thin)
    keep = np.minimum(burn_in + thin * np.arange(num_kept), num_samples - 1)
    return buf[keep].astype(np.float64)
