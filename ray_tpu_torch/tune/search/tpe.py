"""TPESearch — in-tree Tree-structured Parzen Estimator searcher.

Role-equivalent of the reference's HyperOpt adapter
(python/ray/tune/search/hyperopt/hyperopt_search.py), reimplemented
dependency-free: the classic TPE recipe (Bergstra et al. 2011) over the
ray_tpu_torch.tune.search.sample domains.

Per suggest(): completed trials split into "good" (top gamma quantile by
the objective) and "bad"; each dimension builds a Parzen density l(x)
from the good observations (Gaussian mixture for numerics in the
domain's — possibly log — metric space; smoothed counts for
categoricals) and g(x) from the bad ones; n_candidates samples drawn
from l are scored by l(x)/g(x) and the argmax wins. Until
n_initial_points trials complete, suggestions are random (the warmup
that seeds the densities).

Copied from ray_tpu's ``tune/search/tpe.py``: fed the same results, it
makes the same suggestions.
"""

from __future__ import annotations

import math
import random
from typing import Any, Optional

from ray_tpu_torch.tune.search.sample import (
    Categorical, Domain, Float, Function, Integer, Quantized,
)
from ray_tpu_torch.tune.search.searcher import Searcher


def _to_metric_space(domain, value: float) -> float:
    if getattr(domain, "log", False):
        return math.log(value)
    return float(value)


def _from_metric_space(domain, value: float):
    if getattr(domain, "log", False):
        value = math.exp(value)
    if isinstance(domain, Integer):
        return int(min(domain.upper - 1, max(domain.lower, round(value))))
    return float(min(domain.upper, max(domain.lower, value)))


class _NumericParzen:
    """1-D Gaussian mixture over observations in metric space."""

    def __init__(self, domain, observations: list[float]):
        self.domain = domain
        lo = _to_metric_space(domain, domain.lower)
        hi = _to_metric_space(domain, domain.upper)
        self.lo, self.hi = lo, hi
        self.points = [_to_metric_space(domain, v) for v in observations]
        span = max(hi - lo, 1e-12)
        # Silverman-flavored bandwidth, floored so densities never spike
        n = max(len(self.points), 1)
        self.bw = max(span / (n ** 0.5 + 1), span * 0.02)

    def sample(self, rng: random.Random) -> float:
        if not self.points:
            return rng.uniform(self.lo, self.hi)
        center = rng.choice(self.points)
        for _ in range(16):
            draw = rng.gauss(center, self.bw)
            if self.lo <= draw <= self.hi:
                return draw
        return min(self.hi, max(self.lo, draw))

    def pdf(self, x: float) -> float:
        if not self.points:
            return 1.0 / max(self.hi - self.lo, 1e-12)
        total = 0.0
        inv = 1.0 / (self.bw * math.sqrt(2 * math.pi))
        for center in self.points:
            z = (x - center) / self.bw
            total += inv * math.exp(-0.5 * z * z)
        return total / len(self.points) + 1e-12


class _CategoricalParzen:
    def __init__(self, domain: Categorical, observations: list):
        self.domain = domain
        self.counts = {id(c): 1.0 for c in domain.categories}  # +1 smooth
        self._by_id = {id(c): c for c in domain.categories}
        for obs in observations:
            for cat in domain.categories:
                if obs == cat:
                    self.counts[id(cat)] += 1.0
                    break
        self.total = sum(self.counts.values())

    def sample(self, rng: random.Random):
        r = rng.uniform(0, self.total)
        acc = 0.0
        for key, weight in self.counts.items():
            acc += weight
            if r <= acc:
                return self._by_id[key]
        return self.domain.categories[-1]

    def pdf(self, value) -> float:
        for cat in self.domain.categories:
            if value == cat:
                return self.counts[id(cat)] / self.total
        return 1e-12


class TPESearch(Searcher):
    def __init__(
        self,
        space: dict | None = None,
        metric: str | None = None,
        mode: str | None = None,
        n_initial_points: int = 10,
        gamma: float = 0.25,
        n_candidates: int = 24,
        seed: int | None = None,
    ):
        super().__init__(metric, mode)
        self._space = dict(space or {})
        self.n_initial_points = n_initial_points
        self.gamma = gamma
        self.n_candidates = n_candidates
        self._rng = random.Random(seed)
        self._live: dict[str, dict] = {}
        self._observations: list[tuple[dict, float]] = []

    def set_search_properties(self, metric, mode, config) -> bool:
        super().set_search_properties(metric, mode, config)
        if config and not self._space:
            self._space = {
                k: v for k, v in config.items() if isinstance(v, Domain)
            }
        return True

    # -- the TPE step ---------------------------------------------------
    def _split(self) -> tuple[list[dict], list[dict]]:
        ranked = sorted(  # best first
            self._observations,
            key=lambda o: (-o[1] if self.mode == "max" else o[1]),
        )
        n_good = max(1, int(math.ceil(self.gamma * len(ranked))))
        good = [cfg for cfg, _ in ranked[:n_good]]
        bad = [cfg for cfg, _ in ranked[n_good:]] or good
        return good, bad

    def _suggest_dimension(self, key: str, domain) -> Any:
        base = domain.inner if isinstance(domain, Quantized) else domain
        good, bad = self._split()
        good_obs = [cfg[key] for cfg in good if key in cfg]
        bad_obs = [cfg[key] for cfg in bad if key in cfg]
        if isinstance(base, Categorical):
            l_density = _CategoricalParzen(base, good_obs)
            g_density = _CategoricalParzen(base, bad_obs)
            candidates = [
                l_density.sample(self._rng) for _ in range(self.n_candidates)
            ]
            best = max(
                candidates,
                key=lambda c: l_density.pdf(c) / g_density.pdf(c),
            )
            return best
        if isinstance(base, (Float, Integer)):
            l_density = _NumericParzen(base, good_obs)
            g_density = _NumericParzen(base, bad_obs)
            draws = [
                l_density.sample(self._rng) for _ in range(self.n_candidates)
            ]
            best = max(
                draws, key=lambda x: l_density.pdf(x) / g_density.pdf(x)
            )
            value = _from_metric_space(base, best)
            if isinstance(domain, Quantized):
                value = round(round(value / domain.q) * domain.q, 10)
            return value
        return domain.sample(self._rng)  # Function and friends: random

    def suggest(self, trial_id: str) -> Optional[dict]:
        if not self._space:
            return None
        config: dict = {}
        warmup = len(self._observations) < self.n_initial_points
        for key, domain in self._space.items():
            if not isinstance(domain, Domain) or isinstance(domain, Function):
                config[key] = (
                    domain.sample(self._rng, config)
                    if isinstance(domain, Function)
                    else domain
                )
            elif warmup:
                config[key] = domain.sample(self._rng)
            else:
                config[key] = self._suggest_dimension(key, domain)
        self._live[trial_id] = config
        return config

    def on_trial_complete(
        self, trial_id: str, result: dict | None = None, error: bool = False
    ) -> None:
        config = self._live.pop(trial_id, None)
        if config is None or error or not result:
            return
        value = result.get(self.metric)
        if value is None:
            return
        self._observations.append((config, float(value)))

    def save(self) -> Any:
        return {
            "observations": self._observations,
            "live": dict(self._live),
            "rng": self._rng.getstate(),
        }

    def restore(self, state: Any) -> None:
        self._observations = list(state["observations"])
        self._live = dict(state.get("live", {}))
        self._rng.setstate(state["rng"])
