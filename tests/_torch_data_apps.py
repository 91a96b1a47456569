"""UDFs, datasources and train loops for the port's data tests
(``tests/test_torch_data.py``, ``tests/test_torch_data_ingest.py``).

The port's data workers take functions by module and qualified name, so
every UDF lives at module level here; the reference's side of each parity
case runs the same functions (its runtime pickles them). The train loops
come in pairs where a test runs both packages: the port's reads
``ray_tpu_torch.train``, the reference's ``ray_tpu.train``.
"""

import json
import os

import numpy as np


# ---------------------------------------------------------------- UDFs
def double(row):
    return {"id": row["id"] * 2}


def div4(row):
    return row["id"] % 4 == 0


def square(batch):
    return {"sq": batch["id"] ** 2}


def identity(batch):
    return batch


def twice(row):
    return [{"x": row["x"]}, {"x": row["x"] * 10}]


def with_str(row):
    return {"id": row["id"], "s": str(row["id"])}


def float_cols(batch):
    ids = batch["id"]
    return {"id": ids, "x": ids * 0.5 - 3.0, "y": (ids % 7).astype(np.float32)}


def add_ab(batch):
    """add_column's fn on the port: the numpy batch in, the column out."""
    return batch["a"] + batch["b"]


def group_total(group):
    return {"k": group["k"][:1], "total": np.array([group["v"].sum()])}


class AddState:
    def __init__(self, offset=1000):
        self.offset = offset

    def __call__(self, batch):
        return {"y": batch["id"] + self.offset}


# ---------------------------------------------------------------- plugins
def read_squares(start: int, end: int):
    yield {"x": list(range(start, end)), "sq": [i * i for i in range(start, end)]}


class SquaresDatasource:
    """tests/test_data.py's custom datasource, its read task a partial of a
    module-level function; ``read_task_cls`` is the package's ReadTask."""

    def __init__(self, n: int, read_task_cls):
        self.n, self.read_task_cls = n, read_task_cls

    def get_name(self):
        return "Squares"

    def get_read_tasks(self, parallelism):
        import functools

        chunk = max(1, self.n // parallelism)
        return [self.read_task_cls(functools.partial(read_squares, start,
                                                     min(start + chunk, self.n)),
                                   num_rows=min(start + chunk, self.n) - start)
                for start in range(0, self.n, chunk)]


class CountingDatasink:
    """Counts the rows each write task got; runs in the data workers."""

    def __init__(self):
        self.started = False
        self.completed = None

    def on_write_start(self):
        self.started = True

    def write(self, blocks, ctx):
        from ray_tpu_torch.data.block import num_rows

        return sum(num_rows(b) for b in blocks)

    def on_write_complete(self, results):
        self.completed = sum(results)

    def on_write_failed(self, error):
        pass


# ---------------------------------------------------------------- workers
def worker_env(_batch):
    """What a data worker sees: its CUDA_VISIBLE_DEVICES, and whether it
    has torch."""
    import sys

    return {"cuda_visible": np.array([os.environ.get("CUDA_VISIBLE_DEVICES", "unset")],
                                     dtype=object),
            "pid": np.array([os.getpid()]),
            "torch": np.array(["torch" in sys.modules])}


def exit_now(_batch):
    """Ends the data worker that runs it."""
    os._exit(3)


# ---------------------------------------------------------------- train loops
def sum_loop(config):
    """tests/test_data.py's ingest loop on the port: each rank sums its
    shard's ids (and writes the ids it saw to ``log_dir``)."""
    from ray_tpu_torch import train

    ctx = train.get_context()
    shard = train.get_dataset_shard("train")
    ids = []
    for batch in shard.iter_batches(batch_size=8):
        ids += [int(x) for x in batch["id"]]
    with open(os.path.join(config["log_dir"], f"rank{ctx.world_rank}.json"), "w") as f:
        json.dump(ids, f)
    train.report({"total": sum(ids), "fetch_wait_s": shard.fetch_wait_s})


def _log_ids(config, ctx, ids) -> None:
    log = os.path.join(config["log_dir"], f"consumed_r{ctx.world_rank}_{os.getpid()}.jsonl")
    with open(log, "a") as f:
        f.write(json.dumps(ids) + "\n")


def ingest_loop(config):
    """tests/test_train_elastic.py's ``_ingest_loop`` on the port: every
    rank logs the ids it consumed, rank 0 checkpoints every step, and each
    worker writes its pid for the churn callback. With ``kill_step`` set,
    rank 0 exits hard there once (marker-guarded), before reporting."""
    from ray_tpu_torch import train
    from ray_tpu_torch.train.checkpoint import save_pytree_checkpoint
    from ray_tpu_torch.train.release_loops import write_pid

    ctx = train.get_context()
    write_pid(config, ctx.world_rank)
    shard = train.get_dataset_shard("train")
    step = 0
    for batch in shard.iter_batches(batch_size=config["batch_size"]):
        _log_ids(config, ctx, [int(x) for x in batch["id"]])
        checkpoint = None
        if ctx.world_rank == 0:
            checkpoint = save_pytree_checkpoint({"step": step})
        if (ctx.world_rank == 0 and step == config.get("kill_step")
                and not os.path.exists(config["marker"])):
            open(config["marker"], "w").close()
            os._exit(1)
        train.report({"step": step, "world_size": ctx.world_size}, checkpoint=checkpoint)
        step += 1
    train.report({"step": step, "world_size": ctx.world_size, "epoch_done": True})


def logged_ids(log_dir) -> list:
    ids = []
    for name in sorted(os.listdir(log_dir)):
        if name.startswith("consumed_"):
            with open(os.path.join(log_dir, name)) as f:
                for line in f:
                    ids += json.loads(line)
    return ids


def ingest_loop_ref(config):
    """``ingest_loop`` on the JAX package (its ``_ingest_loop``), for the
    committed ingest record's layout."""
    from ray_tpu import train

    ctx = train.get_context()
    shard = train.get_dataset_shard("train")
    step = 0
    for batch in shard.iter_batches(batch_size=config["batch_size"]):
        checkpoint = None
        if ctx.get_world_rank() == 0:
            checkpoint = train.save_pytree_checkpoint({"step": step})
        train.report({"step": step, "world_size": ctx.get_world_size()}, checkpoint=checkpoint)
        step += 1
    train.report({"step": step, "world_size": ctx.get_world_size(), "epoch_done": True})
