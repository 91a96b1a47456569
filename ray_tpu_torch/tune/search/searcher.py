"""Searcher protocol + ConcurrencyLimiter.

Role-equivalent of python/ray/tune/search/searcher.py :: Searcher and
python/ray/tune/search/concurrency_limiter.py :: ConcurrencyLimiter.
A Searcher proposes configs (`suggest`) and learns from completed trials
(`on_trial_complete`); external HPO libs adapt through this interface.

Copied from ray_tpu's ``tune/search/searcher.py``.
"""

from __future__ import annotations

from typing import Any, Optional


class Searcher:
    def __init__(self, metric: str | None = None, mode: str | None = None):
        if mode not in (None, "min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.metric = metric
        self.mode = mode

    def set_search_properties(
        self, metric: str | None, mode: str | None, config: dict
    ) -> bool:
        """Late-bind metric/mode/space from TuneConfig. True if accepted."""
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        return True

    def suggest(self, trial_id: str) -> Optional[dict]:
        """Next config, or None when the space is exhausted / must wait."""
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        pass

    def on_trial_complete(
        self, trial_id: str, result: dict | None = None, error: bool = False
    ) -> None:
        pass

    def save(self) -> Any:
        return None

    def restore(self, state: Any) -> None:
        pass


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions from the wrapped searcher."""

    def __init__(self, searcher: Searcher, max_concurrent: int, batch: bool = False):
        super().__init__(searcher.metric, searcher.mode)
        if max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self.batch = batch
        self._live: set[str] = set()

    def set_search_properties(self, metric, mode, config) -> bool:
        ok = self.searcher.set_search_properties(metric, mode, config)
        self.metric, self.mode = self.searcher.metric, self.searcher.mode
        return ok

    def suggest(self, trial_id: str) -> Optional[dict]:
        if len(self._live) >= self.max_concurrent:
            return None
        config = self.searcher.suggest(trial_id)
        if config is not None:
            self._live.add(trial_id)
        return config

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False) -> None:
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)

    def save(self):
        return {"live": sorted(self._live), "inner": self.searcher.save()}

    def restore(self, state):
        self._live = set(state["live"])
        self.searcher.restore(state["inner"])
