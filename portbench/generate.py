"""The one traffic generator: starting points drawn from the seed.

A traffic file (``traffic/<name>.json``) gives the entry it drives and
how its starts are drawn; this module draws them.  A start is the
configuration's documented start plus ``start_noise`` times a standard
normal vector (one per lane for a batch).  By default start i of a run is
drawn in order from ``numpy.random.default_rng(seed)``.  With ``pool``
set, the run cycles through a fixed pool of that many starts, drawn once
from ``pool_seed``, in an order the seed draws anew for every cycle: every
seed then does the same work in another order, for traffic whose calls
are few and whose work depends on the start.  The same seed gives the
same starts either way.
"""

from __future__ import annotations

import numpy as np


class Starts:
    def __init__(self, x0, noise: float, seed: int, lanes=None, pool=None,
                 pool_seed=0):
        self.x0 = np.asarray(x0, dtype=np.float64)
        self.noise = float(noise)
        self.shape = self.x0.shape if lanes is None else (int(lanes),
                                                          self.x0.size)
        self.rng = np.random.default_rng(int(seed) % (1 << 64))
        self.pool, self.order = None, []
        if pool:
            draw = np.random.default_rng(int(pool_seed))
            self.pool = [self._draw(draw) for _ in range(int(pool))]

    def _draw(self, rng) -> np.ndarray:
        return self.x0 + self.noise * rng.normal(size=self.shape)

    def next(self) -> np.ndarray:
        if self.pool is None:
            return self._draw(self.rng)
        if not self.order:
            self.order = list(self.rng.permutation(len(self.pool)))
        return self.pool[self.order.pop()]

    def documented(self) -> np.ndarray:
        """The documented start (every lane of a batch at it): the
        set-up's input, the same whatever the seed."""
        return np.broadcast_to(self.x0, self.shape).copy()
