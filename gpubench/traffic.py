"""The one generator of the benchmark's traffic: a closed loop of mesh
requests whose parameters come from a traffic file (``traffic/<name>.json``)
and a configuration's parameter list (``configs/<name>.json``).

A traffic file holds:

* ``samples``: the ``samples=`` of every request;
* ``draw``: ``"edit"``, every leaf that the configuration lists under
  ``draw`` scaled by a factor of its own, or ``"repeat"``, the script's own
  values on every request;
* for ``"edit"``: ``low`` and ``high``, the range of the factors;
  ``set_size`` and ``set_seed``, the fixed set of factor rows that every
  run draws from, so that every seed brings the same work in another order;
  ``jitter``, a relative change of every factor drawn from the run's seed
  for each request, so that no two requests of a run are equal and no memo
  of the program hits;
* ``warmup``: how many requests set-up makes (the script's values, then
  the first rows of the set, unjittered);
* ``check_requests``: how many completed requests the check compares
  (drawn from the run's seed);
* ``trace_requests``: how many requests a traced run profiles.
"""

from __future__ import annotations

import numpy as np


class Traffic:
    """The requests of one run: ``warmup()`` and ``request(i)`` return
    parameter dicts for the configuration's ``build``."""

    def __init__(self, spec, config, seed):
        self.spec = spec
        self.samples = int(spec["samples"])
        self.nominal = {k: float(v) for k, v in config["params"].items()}
        self.edit = spec["draw"] == "edit"
        if spec["draw"] not in ("edit", "repeat"):
            raise ValueError("unknown draw %r" % spec["draw"])
        self.keys = list(config["draw"]) if self.edit else []
        self.rng = np.random.default_rng(seed)
        self.order = []
        self.issued = []
        if self.edit:
            set_rng = np.random.default_rng(int(spec["set_seed"]))
            self.rows = set_rng.uniform(
                float(spec["low"]), float(spec["high"]),
                (int(spec["set_size"]), len(self.keys)))

    def _values(self, row):
        v = dict(self.nominal)
        for key, factor in zip(self.keys, row):
            v[key] = self.nominal[key] * float(factor)
        return v

    def warmup(self):
        n = int(self.spec["warmup"])
        if not self.edit:
            return [dict(self.nominal)] * n
        return [dict(self.nominal)] + [self._values(r)
                                       for r in self.rows[: n - 1]]

    def request(self, i):
        """Parameters of request ``i`` (drawn in the order 0, 1, 2, ...;
        a request already drawn is handed out again)."""
        while len(self.issued) <= i:
            self.issued.append(self._draw(len(self.issued)))
        return self.issued[i]

    def _draw(self, i):
        if not self.edit:
            return dict(self.nominal)
        k = len(self.rows)
        while len(self.order) <= i:
            self.order.extend(self.rng.permutation(k).tolist())
        jitter = float(self.spec["jitter"]) * self.rng.uniform(
            -1.0, 1.0, len(self.keys))
        return self._values(self.rows[self.order[i]] * (1.0 + jitter))


class Sample:
    """A uniform draw of ``k`` items from a stream of unknown length
    (reservoir sampling from ``seed``)."""

    def __init__(self, k, seed):
        self.k = int(k)
        self.rng = np.random.default_rng([int(seed), 1])
        self.items = []
        self.seen = 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(self.seen))
        if j < self.k:
            self.items[j] = item
