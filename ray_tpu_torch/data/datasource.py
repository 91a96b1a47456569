"""Datasource / Datasink plugin protocol.

Copy of ray_tpu's ``data/datasource.py``: ``Datasource`` (get_read_tasks,
estimate_inmemory_data_size) and ``Datasink`` (on_write_start, write,
on_write_complete, on_write_failed). Custom connectors implement these and
plug into read_datasource / Dataset.write_datasink.

A ``ReadTask``'s ``read_fn`` and a ``Datasink`` run in the data workers, so
they must pickle by name (``_private.local_tasks``): a module-level function
or class, or a ``functools.partial`` of one, never a closure.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional


class ReadTask:
    """One unit of parallel read work: a callable yielding blocks, plus
    optional metadata used for scheduling/row estimates."""

    def __init__(self, read_fn: Callable[[], Iterable], *,
                 num_rows: Optional[int] = None,
                 size_bytes: Optional[int] = None,
                 input_files: Optional[list] = None):
        self._read_fn = read_fn
        self.num_rows = num_rows
        self.size_bytes = size_bytes
        self.input_files = input_files or []

    def __call__(self) -> Iterable:
        return self._read_fn()


class Datasource:
    """Implement get_read_tasks (and optionally the size estimate)."""

    def get_name(self) -> str:
        return type(self).__name__.replace("Datasource", "") or "Custom"

    def estimate_inmemory_data_size(self) -> Optional[int]:
        return None

    def get_read_tasks(self, parallelism: int) -> list[ReadTask]:
        raise NotImplementedError

    # Legacy single-method form: subclasses may implement read_all()
    # returning an iterable of blocks; the default get_read_tasks wraps it.


class Datasink:
    """Implement write(); lifecycle hooks are optional."""

    def on_write_start(self) -> None:
        pass

    def write(self, blocks: Iterable, ctx: dict) -> Any:
        """Called once per write task with an iterable of blocks (the port's
        blocks: dicts of numpy columns). Returns an opaque per-task result passed to
        on_write_complete."""
        raise NotImplementedError

    def on_write_complete(self, write_results: list) -> None:
        pass

    def on_write_failed(self, error: Exception) -> None:
        pass

    @property
    def num_rows_per_write(self) -> Optional[int]:
        return None
