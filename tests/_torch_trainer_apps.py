"""Train loops for the port's elastic and config-1 tests
(``tests/test_torch_elastic.py``, ``tests/test_torch_elastic_resize.py``,
``tests/test_torch_fashion_mnist.py``) that the port's package does not
ship: the JAX package's loops the tests hold the port against, and the
port's test-only loops.

The release scripts' loops on the port, and the churn callback, are
``ray_tpu_torch.train.release_loops``; the reference's twins here keep
each script's steps as it has them. The port's gang members import these
by name; the reference's trainer pickles them.
"""

import os
import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.train.config import FailureConfig, RunConfig, ScalingConfig
from ray_tpu_torch.train.release_loops import write_pid, write_rank
from ray_tpu_torch.train.trainer import TorchTrainer

# A gang member's bundle in the elastic tests: a CPU and one of the
# declared trainslots.
SLOTS = {"CPU": 1, "trainslot": 1}


@pytest.fixture(scope="module")
def slots():
    """A cluster of the module's (``ray_tpu_torch.init``) with 8 CPUs and
    four trainslots."""
    rt.init(num_cpus=8, resources={"trainslot": 4})
    yield
    rt.shutdown()


def elastic_fit(tmp_path, name, loop, config, callbacks, *, workers=4, min_workers=2,
                probe_s=5.0, use_gpu=False, resources_per_worker=SLOTS, max_failures=2,
                datasets=None):
    """``TorchTrainer(loop).fit()`` on an elastic gang of ``workers`` down
    to ``min_workers``, each formation bounded by 1 s; the loop's config
    gets ``pid_dir`` (``tmp_path``) for the churn callbacks."""
    trainer = TorchTrainer(
        loop, train_loop_config={"pid_dir": str(tmp_path), **config},
        scaling_config=ScalingConfig(
            num_workers=workers, min_workers=min_workers, use_gpu=use_gpu,
            resources_per_worker=resources_per_worker, elastic_formation_timeout_s=1.0,
            elastic_grow_probe_period_s=probe_s),
        run_config=RunConfig(name=name, storage_path=str(tmp_path / "runs"),
                             failure_config=FailureConfig(max_failures=max_failures),
                             callbacks=callbacks),
        datasets=datasets)
    return trainer.fit()


def transitions(result) -> list:
    """A result's resizes as the reference's tests read them."""
    return [{k: r[k] for k in ("reason", "from", "to")} for r in result.resizes]


def worlds(result) -> list:
    """The world sizes the run's gangs reported, each run of equal sizes
    once: [4, 3, 4] for a step-down and a grow-back."""
    out = []
    for m in result.metrics_history:
        if not out or out[-1] != m["world_size"]:
            out.append(m["world_size"])
    return out


# ------------------------------------------------- the port's test loops
def elastic_loop(config):
    """tests/test_train_elastic.py's ``_elastic_loop`` on the port: rank 0
    checkpoints {"step"} every step; a resumed gang starts after it."""
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.checkpoint import load_pytree_checkpoint, save_pytree_checkpoint

    ctx = session.get_context()
    write_pid(config, ctx.world_rank)
    start = 0
    ckpt = session.get_checkpoint()
    if ckpt is not None:
        state, _ = load_pytree_checkpoint(ckpt)
        start = int(state["step"]) + 1
    for step in range(start, config["steps"]):
        checkpoint = None
        if ctx.world_rank == 0:
            checkpoint = save_pytree_checkpoint({"step": step})
        session.report({"step": step, "world_size": ctx.world_size, "resumed": start > 0},
                       checkpoint=checkpoint)


def fsdp_loop(config):
    """The tiny model on a {fsdp: world} mesh of the gang that formed,
    AdamW through ``setup_sharded_training``: it saves the sharded state
    at step ``save_at`` (and writes the full state it saved, rank 0), and
    a resumed gang writes the full state ``restore_sharded_state`` placed
    on its own mesh before it goes on."""
    import torch

    from ray_tpu_torch.models import transformer as pt
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.parallel.mesh import tree_leaves, tree_map
    from ray_tpu_torch.train import session, torch_utils
    from ray_tpu_torch.train.step import make_optimizer

    ctx = session.get_context()
    write_pid(config, ctx.world_rank)
    model = pt.TransformerConfig.tiny()
    init = config["init"]

    def init_fn(device):
        if device == "meta":
            return tree_map(lambda a: torch.empty(a.shape, device="meta"), init)
        return params_from_numpy(init, device=device)

    mesh = torch_utils.build_mesh({"fsdp": ctx.world_size}, "cpu")
    setup = torch_utils.setup_sharded_training(init_fn, make_optimizer, mesh=mesh,
                                               logical_dims=pt.param_logical_dims(model))
    step = torch_utils.build_sharded_train_step(
        lambda p, tok: pt.loss_fn(p, tok[:, :-1], tok[:, 1:], model), setup)

    def full_state(params, opt):
        """Every parameter and its Adam step and moments, whole."""
        out = {}
        for path, leaf in tree_leaves(params):
            name, st = "/".join(map(str, path)), opt.state[leaf]
            for key, t in (("param", leaf), ("mu", st["exp_avg"]), ("nu", st["exp_avg_sq"])):
                t = t.full_tensor() if hasattr(t, "full_tensor") else t
                out[f"{key}:{name}"] = t.detach().numpy().copy()
            out[f"step:{name}"] = np.asarray(float(st["step"]))
        return out

    start, resumed = 0, session.get_checkpoint()
    params, opt = setup.params, setup.opt_state
    if resumed is not None:
        params, opt, extra = torch_utils.restore_sharded_state(resumed, setup)
        start = extra["step"]
        state = full_state(params, opt)
        if ctx.world_rank == 0:
            np.savez(os.path.join(config["out_dir"], f"restored_w{ctx.world_size}.npz"), **state)
    for i in range(start, config["steps"]):
        tokens = np.random.default_rng(1000 + i).integers(0, 256, (4, 17)).astype(np.int32)
        params, opt, loss = step(params, opt, setup.shard_batch(torch.from_numpy(tokens)))
        checkpoint = None
        if i + 1 == config["save_at"]:
            checkpoint = torch_utils.save_sharded_state(params, opt, extra={"step": i + 1})
            state = full_state(params, opt)
            if ctx.world_rank == 0:
                np.savez(os.path.join(config["out_dir"], f"saved_w{ctx.world_size}.npz"),
                         **state)
        session.report({"step": i + 1, "loss": float(loss), "world_size": ctx.world_size},
                       checkpoint=checkpoint)


def cards_loop(config):
    """A dp all-reduce a step on NCCL workers, one a card: each report holds
    every rank's card, as its lease named it (gathered), and rank 0
    checkpoints {"step"}."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.checkpoint import load_pytree_checkpoint, save_pytree_checkpoint

    ctx = session.get_context()
    device = torch.device(ctx.device)
    start, ckpt = 0, session.get_checkpoint()
    if ckpt is not None:
        state, _ = load_pytree_checkpoint(ckpt)
        start = int(state["step"]) + 1
    for step in range(start, config["steps"]):
        grad = torch.full((1024,), float(ctx.world_rank + 1), device=device)
        dist.all_reduce(grad)
        cards = [None] * ctx.world_size
        # The card this member's lease named (each member sees its own as 0).
        dist.all_gather_object(cards, int(os.environ["CUDA_VISIBLE_DEVICES"]))
        checkpoint = save_pytree_checkpoint({"step": step}) if ctx.world_rank == 0 else None
        session.report({"step": step, "world_size": ctx.world_size, "cards": cards,
                        "sum": float(grad[0])}, checkpoint=checkpoint)


# ------------------------------------------------- the reference's loops
def quadratic_loop_ref(config):
    """release/benchmarks_elastic.py's ``_train_loop`` as it is."""
    from ray_tpu import train

    ctx = train.get_context()
    w = np.zeros(8, dtype=np.float64)
    start = 0
    ckpt = train.get_checkpoint()
    if ckpt is not None:
        state, _ = train.load_pytree_checkpoint(ckpt)
        w = np.asarray(state["w"], dtype=np.float64)
        start = int(state["step"]) + 1
    target = np.arange(8, dtype=np.float64)
    for step in range(start, config["steps"]):
        time.sleep(config["step_time_s"])
        loss = float(np.sum((w - target) ** 2))
        w = w - 0.05 * (2.0 * (w - target))
        checkpoint = None
        if ctx.get_world_rank() == 0:
            checkpoint = train.save_pytree_checkpoint({"w": w, "step": step})
        train.report({"step": step, "loss": loss, "world_size": ctx.get_world_size()},
                     checkpoint=checkpoint)


def fashion_mnist_loop_ref(config):
    """release/train_fashion_mnist.py:22-63 as it is (the JAX package),
    with each rank's report also written to ``out_dir``."""
    import jax
    import optax

    from ray_tpu import train
    from ray_tpu.models.cnn import CNNConfig, cnn_loss, init_cnn

    ctx = train.get_context()
    cnn_config = CNNConfig()
    params = init_cnn(cnn_config, jax.random.PRNGKey(0))
    optimizer = optax.adam(config["lr"])
    opt_state = optimizer.init(params)
    rank, world = ctx.get_world_rank(), ctx.get_world_size()

    @jax.jit
    def step(params, opt_state, images, labels):
        (loss, acc), grads = jax.value_and_grad(cnn_loss, has_aux=True)(
            params, images, labels, cnn_config)
        updates, opt_state = optimizer.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss, acc

    rng = np.random.default_rng(rank)
    batch = config["batch_size"]
    images = rng.normal(size=(batch, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, size=batch)

    params, opt_state, loss, acc = step(params, opt_state, images, labels)  # warm-up
    start = time.perf_counter()
    steps = config["steps"]
    for _ in range(steps):
        params, opt_state, loss, acc = step(params, opt_state, images, labels)
    jax.block_until_ready(loss)
    elapsed = time.perf_counter() - start
    metrics = {"img_per_s": steps * batch * world / elapsed, "loss": float(loss),
               "acc": float(acc)}
    write_rank(config, rank, metrics, jax.device_get(params))
    train.report(metrics,
                 checkpoint=train.save_pytree_checkpoint(params, extra={"step": steps}))
