"""Search-space primitives.

Role-equivalent of python/ray/tune/search/sample.py :: Domain / Float /
Integer / Categorical / Function and python/ray/tune/search/variant_generator
grid_search marker. Domains are declarative samplers; the variant generator
resolves them against a seeded RNG so experiments are reproducible and
resumable.

Copied from ray_tpu's ``tune/search/sample.py``: one seed draws the same
values in both packages, bit for bit (``randn`` draws from the global
``random``, as the reference's does).
"""

from __future__ import annotations

import random
from typing import Any, Callable, Sequence


class Domain:
    """A sampleable hyperparameter dimension."""

    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class Float(Domain):
    def __init__(self, lower: float, upper: float, log: bool = False):
        if lower >= upper:
            raise ValueError("lower must be < upper")
        if log and lower <= 0:
            raise ValueError("loguniform needs lower > 0")
        self.lower, self.upper, self.log = float(lower), float(upper), log

    def sample(self, rng: random.Random) -> float:
        if self.log:
            import math

            return math.exp(
                rng.uniform(math.log(self.lower), math.log(self.upper))
            )
        return rng.uniform(self.lower, self.upper)

    def quantized(self, q: float) -> "Quantized":
        return Quantized(self, q)

    def __repr__(self):
        kind = "loguniform" if self.log else "uniform"
        return f"{kind}({self.lower}, {self.upper})"


class Integer(Domain):
    def __init__(self, lower: int, upper: int, log: bool = False):
        if lower >= upper:
            raise ValueError("lower must be < upper")
        self.lower, self.upper, self.log = int(lower), int(upper), log

    def sample(self, rng: random.Random) -> int:
        if self.log:
            import math

            return int(
                math.exp(rng.uniform(math.log(self.lower), math.log(self.upper)))
            )
        return rng.randrange(self.lower, self.upper)

    def __repr__(self):
        return f"randint({self.lower}, {self.upper})"


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        if not categories:
            raise ValueError("choice() needs at least one option")
        self.categories = list(categories)

    def sample(self, rng: random.Random) -> Any:
        return rng.choice(self.categories)

    def __repr__(self):
        return f"choice({self.categories!r})"


class Function(Domain):
    """sample_from(lambda spec: ...) — spec exposes resolved config so far."""

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def sample(self, rng: random.Random, spec: Any = None) -> Any:
        try:
            return self.fn(spec)
        except TypeError:
            return self.fn()


class Quantized(Domain):
    def __init__(self, inner: Domain, q: float):
        self.inner, self.q = inner, q

    def sample(self, rng: random.Random) -> float:
        value = self.inner.sample(rng)
        return round(round(value / self.q) * self.q, 10)


class _GridSearch:
    """Marker resolved by BasicVariantGenerator into a cross-product axis."""

    def __init__(self, values: Sequence[Any]):
        if not values:
            raise ValueError("grid_search needs at least one value")
        self.values = list(values)

    def __repr__(self):
        return f"grid_search({self.values!r})"


# -- public constructors (same names as ray.tune.*) --

def uniform(lower: float, upper: float) -> Float:
    return Float(lower, upper)


def loguniform(lower: float, upper: float) -> Float:
    return Float(lower, upper, log=True)


def quniform(lower: float, upper: float, q: float) -> Quantized:
    return Float(lower, upper).quantized(q)


def randint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper)


def lograndint(lower: int, upper: int) -> Integer:
    return Integer(lower, upper, log=True)


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def sample_from(fn: Callable[[Any], Any]) -> Function:
    return Function(fn)


def grid_search(values: Sequence[Any]) -> dict:
    # The reference encodes grid_search as {"grid_search": [...]} dict; keep
    # that wire shape so user configs round-trip through json.
    return {"grid_search": list(values)}


def randn(mean: float = 0.0, sd: float = 1.0) -> Function:
    return Function(lambda _=None: random.gauss(mean, sd))
