"""Spawned gloo ranks for the port's multi-rank parity tests.

``run_ranks(target, world, out_dir, args)`` starts ``world`` processes
(``multiprocessing`` spawn), each joining a gloo (or NCCL) process group through a
``FileStore`` under ``out_dir`` and calling ``target(rank, *args)`` on one
thread; each rank's return value is pickled to ``result<rank>.pkl`` and
its traceback, if it raises, to ``error<rank>.txt``. ``parent`` runs in
the test's process meanwhile (the JAX reference). Ranks that outlast
``timeout_s`` are killed. ``target`` must be importable (module level):
the children import it by name, and neither it nor its module may import
JAX at module level.
"""

import multiprocessing
import os
import pickle
import time
import traceback


def _rank_main(target, rank, world, store, out_dir, args, backend):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world)
        result = target(rank, *args)
        with open(os.path.join(out_dir, f"result{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(target, world, out_dir, args=(), *, timeout_s=120.0, parent=None,
              backend="gloo"):
    """(list of each rank's result, parent's result). ``backend="nccl"``
    puts rank r on card r."""
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(str(out_dir), "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(target, rank, world, store, str(out_dir), tuple(args),
                               backend))
             for rank in range(world)]
    start = time.monotonic()
    for p in procs:
        p.start()
    try:
        parent_result = parent() if parent is not None else None
        for p in procs:
            p.join(max(1.0, timeout_s - (time.monotonic() - start)))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    errors = [open(os.path.join(str(out_dir), f"error{r}.txt")).read() for r in range(world)
              if os.path.exists(os.path.join(str(out_dir), f"error{r}.txt"))]
    assert not errors, "\n".join(errors)
    assert not alive, f"{len(alive)} ranks outlasted {timeout_s} s and were killed"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    results = []
    for rank in range(world):
        with open(os.path.join(str(out_dir), f"result{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results, parent_result
