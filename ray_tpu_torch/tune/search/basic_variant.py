"""Grid + random search.

Role-equivalent of python/ray/tune/search/basic_variant.py ::
BasicVariantGenerator. Resolves a param_space into concrete trial configs:
grid_search axes expand as a cross product, Domain leaves sample from a
seeded RNG, and the whole expansion repeats `num_samples` times.

Copied from ray_tpu's ``tune/search/basic_variant.py``: one seed gives
the same variants, in the same order, in both packages.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Iterator, Optional

from ray_tpu_torch.tune.search.sample import Domain, Function, _GridSearch
from ray_tpu_torch.tune.search.searcher import Searcher


def _is_grid(value: Any) -> bool:
    return (
        isinstance(value, _GridSearch)
        or (isinstance(value, dict) and set(value) == {"grid_search"})
    )


def _grid_values(value: Any) -> list:
    return value.values if isinstance(value, _GridSearch) else value["grid_search"]


def _walk(space: dict, path=()) -> Iterator[tuple[tuple, Any]]:
    for key, value in space.items():
        here = path + (key,)
        if isinstance(value, dict) and not _is_grid(value):
            yield from _walk(value, here)
        else:
            yield here, value


def _set_path(config: dict, path: tuple, value: Any) -> None:
    node = config
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


class _Spec:
    """`spec.config` view handed to sample_from lambdas."""

    def __init__(self, config: dict):
        self.config = config


def generate_variants(
    space: dict, rng: random.Random
) -> Iterator[dict]:
    """One full expansion of the space: cross product of grids × one sample
    of every Domain leaf. sample_from leaves resolve last, seeing the
    partially-resolved config."""
    leaves = list(_walk(space))
    grid_axes = [(p, _grid_values(v)) for p, v in leaves if _is_grid(v)]
    grid_paths = [p for p, _ in grid_axes]
    for combo in itertools.product(*[vals for _, vals in grid_axes]) if grid_axes else [()]:
        config: dict = {}
        for path, value in zip(grid_paths, combo):
            _set_path(config, path, value)
        deferred: list[tuple[tuple, Function]] = []
        for path, value in leaves:
            if path in grid_paths:
                continue
            if isinstance(value, Function):
                deferred.append((path, value))
            elif isinstance(value, Domain):
                _set_path(config, path, value.sample(rng))
            else:
                _set_path(config, path, value)
        for path, fn in deferred:
            _set_path(config, path, fn.sample(rng, _Spec(config)))
        yield config


class BasicVariantGenerator(Searcher):
    def __init__(
        self,
        space: dict | None = None,
        num_samples: int = 1,
        random_state: int | None = None,
        points_to_evaluate: list[dict] | None = None,
        max_concurrent: int = 0,
    ):
        super().__init__()
        self._space = space or {}
        self._num_samples = num_samples
        self._seed = random_state
        self._rng = random.Random(random_state)
        self._points = list(points_to_evaluate or [])
        self.max_concurrent = max_concurrent
        self._iterator: Optional[Iterator[dict]] = None
        self._emitted = 0

    def set_search_properties(self, metric, mode, config) -> bool:
        super().set_search_properties(metric, mode, config)
        if config and not self._space:
            self._space = config
            self._iterator = None
        return True

    @property
    def total_samples(self) -> int:
        grid = 1
        for _, value in _walk(self._space):
            if _is_grid(value):
                grid *= len(_grid_values(value))
        return grid * self._num_samples + len(self._points)

    def _variants(self) -> Iterator[dict]:
        for point in self._points:
            yield dict(point)
        for _ in range(self._num_samples):
            yield from generate_variants(self._space, self._rng)

    def suggest(self, trial_id: str) -> Optional[dict]:
        if self._iterator is None:
            self._iterator = self._variants()
        try:
            config = next(self._iterator)
        except StopIteration:
            return None
        self._emitted += 1
        return config

    def save(self):
        # Replaying `emitted` suggestions against the same seed reproduces
        # RNG state, so resume only needs the counter.
        return {"emitted": self._emitted, "seed": self._seed}

    def restore(self, state):
        self._rng = random.Random(state["seed"])
        self._iterator = self._variants()
        for _ in range(state["emitted"]):
            next(self._iterator, None)
        self._emitted = state["emitted"]
