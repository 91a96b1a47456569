"""The release suite's train loops on the port, and the churn callback.

* ``fashion_mnist_loop``: BASELINE config 1, release/train_fashion_mnist.py's
  loop (the Fashion-MNIST CNN, batch 64, Adam, seeded synthetic data, one
  warm-up step, one report with a checkpoint of the params).
* ``quadratic_loop``: release/benchmarks_elastic.py's loop, gradient descent
  on a fixed quadratic, so the loss at step k is a function of k alone and a
  resumed run must reproduce an undisturbed one's losses exactly;
  ``loss_by_step`` reads them from a result.
* ``Churn``: a driver callback that kills one rank and holds its slot, from
  a runtime actor that leases it from the node agent, until the gang runs
  smaller, so an elastic trainer steps down and grows back. (The
  reference's release script adds and removes nodes through
  ``cluster_utils``, which waits for ROADMAP Queue A item 14c.)
* ``fashion_mnist_dataset_loop``: config 1's loop fed by the trainer's
  dataset (``get_dataset_shard("train").iter_torch_batches``) in place of
  the fixed batch, over one epoch; ``fashion_mnist_rows`` and
  ``token_rows`` are the data workers' UDFs that make seeded rows of
  Fashion-MNIST's train-split shape and of token sequences from row ids.

Gang members import these by name, so they live at module level here.
chip_smoke.py runs them on the card's machine; the CPU tests hold them
against the JAX package's loops of the same scripts.
"""

import json
import os
import signal
import sys
import time

import numpy as np


def write_pid(config, rank: int) -> None:
    """This worker's process id in ``<pid_dir>/rank<r>.pid`` (when the
    config names a ``pid_dir``): ``Churn`` kills a rank by it."""
    if config.get("pid_dir"):
        path = os.path.join(config["pid_dir"], f"rank{rank}.pid")
        with open(f"{path}.tmp", "w") as f:
            f.write(str(os.getpid()))
        os.replace(f"{path}.tmp", path)


def quadratic_loop(config):
    """``config``: ``steps``, ``step_time_s`` (the emulated step's compute)
    and optionally ``pid_dir``. Rank 0 checkpoints {"w", "step"} every
    step; a resumed gang starts after the latest."""
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.checkpoint import load_pytree_checkpoint, save_pytree_checkpoint

    ctx = session.get_context()
    write_pid(config, ctx.world_rank)
    w = np.zeros(8, dtype=np.float64)
    start = 0
    ckpt = session.get_checkpoint()
    if ckpt is not None:
        state, _ = load_pytree_checkpoint(ckpt)
        w = np.asarray(state["w"], dtype=np.float64)
        start = int(state["step"]) + 1
    target = np.arange(8, dtype=np.float64)
    for step in range(start, config["steps"]):
        time.sleep(config["step_time_s"])
        loss = float(np.sum((w - target) ** 2))
        w = w - 0.05 * (2.0 * (w - target))
        checkpoint = None
        if ctx.world_rank == 0:
            checkpoint = save_pytree_checkpoint({"w": w, "step": step})
        session.report({"step": step, "loss": loss, "world_size": ctx.world_size},
                       checkpoint=checkpoint)


def loss_by_step(result) -> dict:
    """release/benchmarks_elastic.py's ``_loss_by_step``: replayed steps
    report again, and the last report of a step is the one that counted."""
    return {int(m["step"]): float(m["loss"]) for m in result.metrics_history if "loss" in m}


class _SlotHolder:
    """An actor that does nothing but hold what it leased."""

    def ping(self) -> str:
        return "ok"


class Churn:
    """A driver callback: at ``kill_step`` it asks the runtime for an actor
    that leases ``hold`` of the resource ``slot`` (the request waits until
    the dying gang's placement group gives its bundles back, ahead of the
    gang's re-formation, which waits out the trainer's backoff), then kills
    rank ``victim``'s process; once the gang reports a ``world_size`` below
    its first one, it kills the holder when ``restore`` is set and waits
    until the slot shows free, so that the trainer can grow back."""

    def __init__(self, pid_dir, kill_step: int, victim: int = 3, hold: int = 1,
                 slot: str = "trainslot", restore: bool = True, wait_s: float = 60.0):
        self.pid_dir, self.kill_step, self.victim = pid_dir, kill_step, victim
        self.hold, self.slot, self.restore, self.wait_s = hold, slot, restore, wait_s
        self.killed = self.restored = False
        self.holder = None
        self.world_sizes: list[int] = []

    def on_result(self, metrics):
        import ray_tpu_torch

        self.world_sizes.append(metrics.get("world_size"))
        if not self.killed and metrics.get("step", -1) >= self.kill_step:
            self.killed = True
            self.holder = ray_tpu_torch.remote(_SlotHolder).options(
                num_cpus=0, resources={self.slot: float(self.hold)}).remote()
            with open(os.path.join(self.pid_dir, f"rank{self.victim}.pid")) as f:
                os.kill(int(f.read()), signal.SIGKILL)
        elif (self.killed and self.restore and not self.restored
              and metrics.get("world_size") < self.world_sizes[0]):
            self.restored = True
            ray_tpu_torch.get(self.holder.ping.remote(), timeout=self.wait_s)
            self.release()

    def release(self) -> None:
        """Kills the holder, if any, and waits (up to ``wait_s``) until the
        cluster's free resources show its slot back, so that the trainer's
        next grow probe finds it."""
        import ray_tpu_torch

        if self.holder is None:
            return
        before = ray_tpu_torch.available_resources().get(self.slot, 0.0)
        ray_tpu_torch.kill(self.holder)
        self.holder = None
        deadline = time.monotonic() + self.wait_s
        while (ray_tpu_torch.available_resources().get(self.slot, 0.0) < before + self.hold
               and time.monotonic() < deadline):
            time.sleep(0.01)


# ------------------------------------------------- BASELINE config 1 (Fashion-MNIST)
def _port_launches() -> int:
    """The port's kernel launches in this process so far (0 where no op
    module was imported)."""
    total = 0
    flash = sys.modules.get("ray_tpu_torch.ops.flash_attention")
    if flash is not None:
        total += (flash.flash_attention.launches + flash._flash_bwd_dq.launches
                  + flash._flash_bwd_dkv.launches)
    rms = sys.modules.get("ray_tpu_torch.ops.rmsnorm")
    if rms is not None:
        total += rms.rmsnorm.launches + rms.rmsnorm_backward.launches
    return total


def flat(tree, prefix: str = "") -> dict:
    """A tree of dicts and lists as {"convs/0/w": array, ...}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out = {}
    for key, value in items:
        out.update(flat(value, f"{prefix}/{key}" if prefix else str(key)))
    return out


def write_rank(config, rank: int, metrics: dict, params: dict) -> None:
    """Rank ``rank``'s reported metrics and final params (a numpy tree in
    the JAX package's layout) in ``out_dir``, when the config names one:
    the trainer's result holds rank 0's metrics only."""
    if config.get("out_dir"):
        with open(os.path.join(config["out_dir"], f"rank{rank}.json"), "w") as f:
            json.dump(metrics, f)
        np.savez(os.path.join(config["out_dir"], f"rank{rank}.npz"), **flat(params))


def fashion_mnist_loop(config):
    """``config``: ``params`` (a numpy tree in the JAX package's layout, as
    ``init_cnn(CNNConfig(), PRNGKey(0))`` makes it), ``lr``, ``batch_size``,
    ``steps``, and optionally ``out_dir`` and ``logits``. Runs on the
    worker's device in f32 with TF32 off. The report adds the port's kernel
    launches in the worker (the CNN has none), and rank 0's the logits of
    the first step's forward when ``logits`` is set."""
    import torch

    from ray_tpu_torch.models.cnn import CNNConfig, cnn_forward, cnn_loss
    from ray_tpu_torch.models.convert import conv_params_from_numpy, conv_params_to_numpy
    from ray_tpu_torch.train import get_context, report
    from ray_tpu_torch.train.checkpoint import save_pytree_checkpoint
    from ray_tpu_torch.train.step import named_leaves

    ctx = get_context()
    device = torch.device(ctx.device or "cpu")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cnn_config = CNNConfig()
    params = conv_params_from_numpy(config["params"], device=device)
    leaves = [leaf.requires_grad_(True) for _, leaf in named_leaves(params)]
    optimizer = torch.optim.Adam(leaves, lr=config["lr"], betas=(0.9, 0.999), eps=1e-8)
    rank, world = ctx.world_rank, ctx.world_size

    rng = np.random.default_rng(rank)
    batch = config["batch_size"]
    images = torch.from_numpy(rng.normal(size=(batch, 28, 28, 1)).astype(np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, 10, size=batch)).to(device)

    def step():
        loss, acc = cnn_loss(params, images, labels, cnn_config)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach(), acc

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.no_grad():
        logits = cnn_forward(params, images, cnn_config)
    loss, acc = step()  # warm-up
    sync()
    start = time.perf_counter()
    steps = config["steps"]
    for _ in range(steps):
        loss, acc = step()
    sync()
    elapsed = time.perf_counter() - start
    metrics = {"img_per_s": steps * batch * world / elapsed, "loss": float(loss),
               "acc": float(acc), "launches": _port_launches()}
    if config.get("out_dir"):
        write_rank(config, rank, metrics, conv_params_to_numpy(params))
    if config.get("logits") and rank == 0:
        metrics["first_logits"] = logits.cpu().tolist()
    report(metrics, checkpoint=save_pytree_checkpoint(params, extra={"step": steps}))


# ------------------------------------------------- datasets (config 1 fed by a Dataset)
# Fashion-MNIST's train split: 60,000 rows of 28x28x1 f32 images and int64
# labels in [0, 10). The real files are not in the repository; these rows
# are seeded synthetic images of the same shape.
FMNIST_TRAIN_ROWS = 60_000


def fashion_mnist_rows(batch, seed: int = 0):
    """A map_batches UDF: each row's image (standard normal, f32) and label
    from a generator seeded by (seed, row id), so a row's content depends on
    its id alone, whatever the block layout or order."""
    ids = np.asarray(batch["id"])
    images = np.empty((len(ids), 28, 28, 1), dtype=np.float32)
    labels = np.empty(len(ids), dtype=np.int64)
    for i, row in enumerate(ids.tolist()):
        rng = np.random.default_rng([seed, row])
        images[i] = rng.standard_normal((28, 28, 1), dtype=np.float32)
        labels[i] = rng.integers(0, 10)
    return {"id": ids, "image": images, "label": labels}


def token_rows(batch, seed: int, vocab_size: int, length: int):
    """A map_batches UDF: each row's ``length`` tokens in [0, vocab_size)
    from a generator seeded by (seed, row id)."""
    ids = np.asarray(batch["id"])
    tokens = np.empty((len(ids), length), dtype=np.int64)
    for i, row in enumerate(ids.tolist()):
        tokens[i] = np.random.default_rng([seed, row]).integers(0, vocab_size, length)
    return {"id": ids, "tokens": tokens}


def fashion_mnist_dataset_loop(config):
    """``fashion_mnist_loop`` reading one epoch of the trainer's dataset
    ``"train"`` (rows of ``fashion_mnist_rows``) through
    ``iter_torch_batches(batch_size=..., drop_last=True)``: the first batch's
    step is the warm-up, the rest are timed. Reports every
    ``report_every`` steps (each report carries the worker's StepStats
    record, whose data wait is the shard's), then the epoch's img/s, the
    rows it consumed (count, distinct count, sum of ids), the shard's data
    wait over the timed steps and a checkpoint of the params."""
    import torch

    from ray_tpu_torch.models.cnn import CNNConfig, cnn_loss
    from ray_tpu_torch.models.convert import conv_params_from_numpy
    from ray_tpu_torch.train import get_context, get_dataset_shard, report
    from ray_tpu_torch.train.checkpoint import save_pytree_checkpoint
    from ray_tpu_torch.train.step import named_leaves

    ctx = get_context()
    device = torch.device(ctx.device or "cpu")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cnn_config = CNNConfig()
    params = conv_params_from_numpy(config["params"], device=device)
    leaves = [leaf.requires_grad_(True) for _, leaf in named_leaves(params)]
    optimizer = torch.optim.Adam(leaves, lr=config["lr"], betas=(0.9, 0.999), eps=1e-8)
    shard = get_dataset_shard("train")
    batch_size, every = config["batch_size"], config.get("report_every", 100)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    ids: list[int] = []
    steps, start, wait0 = 0, None, 0.0
    loss = acc = None
    for batch in shard.iter_torch_batches(batch_size=batch_size, drop_last=True):
        images = batch["image"].to(device, non_blocking=True)
        labels = batch["label"].to(device, non_blocking=True)
        ids += batch["id"].tolist()
        loss, acc = cnn_loss(params, images, labels, cnn_config)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        loss, acc = loss.detach(), acc.detach()
        steps += 1
        if start is None:  # the first step is the warm-up
            sync()
            start, wait0 = time.perf_counter(), shard.fetch_wait_s
        elif steps % every == 0:
            report({"step": steps, "loss": float(loss)})
    sync()
    elapsed = time.perf_counter() - start
    timed = steps - 1
    report({"step": steps, "steps": steps, "loss": float(loss), "acc": float(acc),
            "img_per_s": timed * batch_size * ctx.world_size / elapsed, "timed_s": elapsed,
            "data_wait_s": shard.fetch_wait_s - wait0, "rows": len(ids),
            "distinct_rows": len(set(ids)), "id_sum": int(sum(ids)),
            "launches": _port_launches()},
           checkpoint=save_pytree_checkpoint(params, extra={"step": steps}))
