"""The members of a run: each a forecast from the configuration's start plus
one of a fixed pool of small, smooth perturbations of t, u and v.

The pool (``pool`` members, the configuration's ``perturbation``) is drawn
once from a fixed seed, so that every run does the same set of work: the
adaptive convection's sweeps, and so the time a member takes, depend on
its flow.  A run's seed orders the pool: member ``k`` of the run is pool
member ``order[k]``, each pass over the pool in its own order.

The perturbation of a field is a sum of ``modes`` products
``cos(m lambda + phase) sin(n chi)`` with chi the colatitude (so it
vanishes at the poles), random integer wavenumbers ``1 <= m <= max_m``,
``1 <= n <= max_n``, random phases and random weights per mode and layer,
scaled so that its largest magnitude is the configuration's amplitude:
every member moves the same amount of air.  The draws are made on the host
and put on the device once, when the pool is made; a member's fields are
then made in float64 on the device with no read back to the host, so the
program and the reference get the same fields.
"""

import math
import random

import numpy as np
import torch

FIELDS = ("t", "u", "v")
POOL_SEED = 1983


def order(seed, size):
    """The pool indices of a run's members, in order: each pass over the
    pool of ``size`` a permutation drawn from ``seed``."""
    pick = random.Random(seed)
    while True:
        yield from pick.sample(range(size), size)


class Pool:
    """The perturbations of ``spec["pool"]`` members on a ``layers x height
    x width`` grid, on ``device``.  ``spec``: the configuration's
    ``perturbation`` (``pool``, ``t_K``, ``uv_m_s``, ``modes``, ``max_m``,
    ``max_n``).  u sits half a cell east, v half a cell south of the cell
    centres; v is 0 on the southern wall row."""

    def __init__(self, spec, layers, height, width, device):
        self.size = spec["pool"]
        f64 = dict(dtype=torch.float64, device=device)
        dlat, dlon = math.pi / height, 2 * math.pi / width
        chi = (torch.arange(height, **f64) + 0.5) * dlat
        lam = -math.pi + (torch.arange(width, **f64) + 0.5) * dlon
        self.where = dict(t=(chi, lam), u=(chi, lam + dlon / 2),
                          v=(chi + dlat / 2, lam))
        self.amplitude = dict(t=spec["t_K"], u=spec["uv_m_s"],
                              v=spec["uv_m_s"])
        self.shape = (layers, height, width)
        c = spec["modes"]
        self.draws = {}
        for field in FIELDS:
            m, n, phase, weight = [], [], [], []
            for index in range(self.size):
                rng = np.random.default_rng(
                    [POOL_SEED, index, FIELDS.index(field)])
                m.append(rng.integers(1, spec["max_m"] + 1, c))
                n.append(rng.integers(1, spec["max_n"] + 1, c))
                phase.append(rng.uniform(0, 2 * math.pi, c))
                weight.append(rng.standard_normal((c, layers)))
            self.draws[field] = tuple(torch.as_tensor(np.stack(x), **f64)
                                      for x in (m, n, phase, weight))

    def delta(self, index):
        """``{"t": dt, "u": du, "v": dv}`` of pool member ``index``:
        float64 ``(layers, height, width)`` tensors on the pool's device."""
        out = {}
        for field in FIELDS:
            m, n, phase, weight = (x[index] for x in self.draws[field])
            rows, cols = self.where[field]
            zonal = torch.cos(m[:, None] * cols[None] + phase[:, None])
            merid = torch.sin(n[:, None] * rows[None])
            planes = (merid[:, :, None] * zonal[:, None, :]).reshape(
                m.shape[0], -1)
            x = (weight.T @ planes).reshape(self.shape)
            x = x * (self.amplitude[field] / x.abs().max())
            if field == "v":
                x[:, -1, :] = 0.0
            out[field] = x
        return out
