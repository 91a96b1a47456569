"""Checkpoints of the port (``ray_tpu_torch.train.checkpoint`` and
``torch_utils.save_sharded_state`` / ``restore_sharded_state``) against
the JAX package's, both ways.

  * The reference trains ``TransformerConfig.tiny()`` two steps with
    ``optax.adamw(3e-4)`` on a 2-device mesh and saves with its
    ``save_sharded_state``; two spawned gloo ranks restore it onto {dp 2}
    and onto {fsdp 2} and take step 3, which matches the reference's.
  * Two ranks train the port two steps on {fsdp 2} and save their shards
    into one directory; adding only ``treedef.pkl`` (from the JAX tree of
    the same structure), the reference's ``load_pytree`` reads every leaf
    bitwise and its step 3 matches the port's. The port restores the same
    directory onto {tp 2}, and the tp shards it saves read back whole.
  * A torn save (``DONE.p1`` missing) is refused by both readers.
  * A bf16 leaf's shard is the same bytes from either package, and so are
    the manifest and index files; the port reads the reference's bf16
    shards (the reference cannot read its own: ROADMAP Queue C item 8).

The ranks get numpy trees and import neither JAX nor the JAX package: this
module imports JAX only inside fixtures and tests.
"""

import multiprocessing
import os
import pickle
import shutil
import time
import traceback

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import convert
from ray_tpu_torch.models import transformer as pt
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel.mesh import MeshSpec, tree_leaves, tree_map
from ray_tpu_torch.train import checkpoint as port_ckpt
from ray_tpu_torch.train import torch_utils
from ray_tpu_torch.train.step import make_optimizer

WORLD = 2
JOIN_TIMEOUT_S = 240
# The loss of step 3 (computed from the restored state) to the f32 forward
# bound; the params after it to the f32 gradient bound, since an Adam step
# of lr 3e-4 moves each weight by at most about lr.
F32_TOL = 2e-5
STEP_TOL = 2e-4
STEPS = 3


def _batches():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, (4, 33)).astype(np.int32) for _ in range(STEPS)]


def _loss(config):
    def loss(params, tok):
        return pt.loss_fn(params, tok[:, :-1], tok[:, 1:], config)
    return loss


def _setup(init_tree, axes):
    config = pt.TransformerConfig.tiny()

    def init(device):
        if device == "meta":
            return tree_map(lambda a: torch.empty(a.shape, device="meta"), init_tree)
        return params_from_numpy(init_tree, device=device)

    return torch_utils.setup_sharded_training(
        init, make_optimizer, mesh=MeshSpec(axes).build("cpu"),
        logical_dims=pt.param_logical_dims(config))


def _full(tree):
    # Copies: a replicated leaf's full_tensor() shares the parameter's storage.
    return {"/".join(map(str, path)): (leaf.full_tensor() if hasattr(leaf, "full_tensor")
                                       else leaf).detach().numpy().copy()
            for path, leaf in tree_leaves(tree)}


def _step(setup, batch):
    step = torch_utils.build_sharded_train_step(_loss(pt.TransformerConfig.tiny()), setup)
    params, opt, loss = step(setup.params, setup.opt_state,
                             setup.shard_batch(torch.from_numpy(batch)))
    return float(loss), _full(params)


# ------------------------------------------------------------- child side
def _worker(rank, store, out_dir, init_tree, batches, ref_ckpt):
    torch.set_num_threads(1)
    import torch.distributed as dist

    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=WORLD)
        results = {}
        # The reference's checkpoint onto two factorizations, then step 3.
        for name, axes in (("dp2", {"dp": 2}), ("fsdp2", {"fsdp": 2})):
            setup = _setup(init_tree, axes)
            torch_utils.restore_sharded_state(port_ckpt.Checkpoint(ref_ckpt), setup)
            state = setup.opt_state.state[setup.params["embed"]]
            results[("restored_step", name)] = float(state["step"])
            results[("step3", name)] = _step(setup, batches[2])
        # Two steps of the port on {fsdp 2}, saved by both ranks into one
        # directory, then step 3.
        setup = _setup(init_tree, {"fsdp": 2})
        for batch in batches[:2]:
            _step(setup, batch)
        opt_tree = convert.optax_adam_state(setup.opt_state, setup.params)
        port_ckpt.save_pytree(os.path.join(out_dir, "port_ckpt"),
                              {"params": setup.params, "opt_state": opt_tree},
                              process_index=rank, world_size=WORLD)
        saved = {"params": _full(setup.params), "mu": _full(opt_tree[0]["mu"]),
                 "nu": _full(opt_tree[0]["nu"]), "count": int(opt_tree[0]["count"])}
        results["port_saved"] = saved
        results["port_step3"] = _step(setup, batches[2])
        # The port's own checkpoint onto another factorization, {tp 2},
        # whose shards that mesh then saves with their global index.
        dist.barrier()  # both ranks' shards and markers are written
        setup = _setup(init_tree, {"tp": 2})
        torch_utils.restore_sharded_state(port_ckpt.Checkpoint(
            os.path.join(out_dir, "port_ckpt")), setup)
        port_ckpt.save_pytree(os.path.join(out_dir, "port_ckpt_tp"), {"params": setup.params},
                              process_index=rank, world_size=WORLD)
        results["tp_restored"] = _full(setup.params)
        results["tp_step3"] = _step(setup, batches[2])
        if rank == 0:
            with open(os.path.join(out_dir, "results.pkl"), "wb") as f:
                pickle.dump(results, f)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


# ------------------------------------------------------------ parent side
def _jax_setup(axes, devices):
    import jax
    import optax

    from ray_tpu.models import transformer as jt
    from ray_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
    from ray_tpu.train import jax_utils

    config = jt.TransformerConfig.tiny()
    opt = optax.adamw(3e-4)
    setup = jax_utils.setup_sharded_training(
        lambda: jt.init_params(config, jax.random.PRNGKey(0)), opt,
        mesh=JaxMeshSpec(axes).build(devices[:2]), logical_dims=jt.param_logical_dims(config))

    def loss(params, tok):
        return jt.loss_fn(params, tok[:, :-1], tok[:, 1:], config)

    return setup, jax_utils.build_sharded_train_step(loss, opt, setup), opt


def _jax_full(tree):
    import jax

    return {"/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                     for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def cross(tmp_path_factory, cpu_mesh_devices):
    import jax

    from ray_tpu.train import jax_utils

    jax.config.update("jax_threefry_partitionable", True)
    out_dir = tmp_path_factory.mktemp("checkpoint")
    batches = _batches()
    setup, step, _ = _jax_setup({"dp": 2}, cpu_mesh_devices)
    init_tree = jax.tree.map(np.asarray, setup.params)
    params, opt_state = setup.params, setup.opt_state
    for batch in batches[:2]:
        params, opt_state, _ = step(params, opt_state, setup.shard_batch(batch))
    ref_ckpt = jax_utils.save_sharded_state(params, opt_state).path
    params, opt_state, loss3 = step(params, opt_state, setup.shard_batch(batches[2]))
    jax_step3 = (float(loss3), _jax_full(params))

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(rank, str(out_dir / "store"), str(out_dir),
                                               init_tree, batches, ref_ckpt))
             for rank in range(WORLD)]
    start = time.monotonic()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(1.0, JOIN_TIMEOUT_S - (time.monotonic() - start)))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    errors = [(out_dir / f"error{r}.txt").read_text() for r in range(WORLD)
              if (out_dir / f"error{r}.txt").exists()]
    assert not alive, f"{len(alive)} ranks outlasted {JOIN_TIMEOUT_S} s and were killed"
    assert not errors and all(p.exitcode == 0 for p in procs), "\n".join(errors)
    with open(out_dir / "results.pkl", "rb") as f:
        results = pickle.load(f)
    return results, jax_step3, out_dir, init_tree, batches


def _max_err(a: dict, b: dict) -> float:
    assert a.keys() == b.keys()
    return max(float(np.max(np.abs(np.asarray(a[k], np.float32) - b[k]))) for k in a)


@pytest.mark.parametrize("mesh", ["dp2", "fsdp2"])
def test_reference_checkpoint_restores_in_the_port(cross, mesh):
    """The reference's 2-step checkpoint on {dp 2}, restored by the port on
    {dp 2} or {fsdp 2}: AdamW's step count and step 3 match."""
    results, (jax_loss, jax_params), _, _, _ = cross
    assert results[("restored_step", mesh)] == 2.0
    loss, params = results[("step3", mesh)]
    assert abs(loss - jax_loss) < F32_TOL
    assert _max_err(params, jax_params) < STEP_TOL


def _with_treedef(src, dst):
    """A copy of the port's checkpoint plus treedef.pkl from the JAX tree of
    the same structure: the one file a JAX reader needs."""
    import jax
    import optax

    from ray_tpu.models import transformer as jt

    shutil.copytree(src, dst)
    config = jt.TransformerConfig.tiny()
    params = jax.eval_shape(lambda: jt.init_params(config, jax.random.PRNGKey(0)))
    opt_state = jax.eval_shape(optax.adamw(3e-4).init, params)
    treedef = jax.tree.structure({"params": params, "opt_state": opt_state})
    with open(os.path.join(dst, "treedef.pkl"), "wb") as f:
        pickle.dump(treedef, f)
    return dst


def test_port_checkpoint_restores_in_the_reference(cross, cpu_mesh_devices):
    """Two ranks' shards on {fsdp 2} in one directory: with treedef.pkl
    added, the reference verifies and loads every leaf as the port saved
    it, and its step 3 from there matches the port's."""
    from ray_tpu.train import checkpoint as jax_ckpt

    results, _, out_dir, _, batches = cross
    directory = _with_treedef(out_dir / "port_ckpt", out_dir / "port_ckpt_for_jax")
    assert jax_ckpt.verify_sharded_checkpoint(str(directory)) == (True, "ok")
    setup, step, _ = _jax_setup({"fsdp": 2}, cpu_mesh_devices)
    tree = jax_ckpt.load_pytree(str(directory), {"params": setup.param_shardings,
                                                 "opt_state": setup.opt_shardings})
    saved = results["port_saved"]
    loaded = _jax_full(tree["params"])
    for name, value in saved["params"].items():
        np.testing.assert_array_equal(loaded[name], value)
    adam = tree["opt_state"][0]
    assert int(adam.count) == saved["count"] == 2
    for moment, key in ((adam.mu, "mu"), (adam.nu, "nu")):
        for name, value in _jax_full(moment).items():
            np.testing.assert_array_equal(value, saved[key][name])
    params, _, loss3 = step(tree["params"], tree["opt_state"], setup.shard_batch(batches[2]))
    port_loss, port_params = results["port_step3"]
    assert abs(float(loss3) - port_loss) < F32_TOL
    assert _max_err(port_params, _jax_full(params)) < STEP_TOL


def test_port_checkpoint_restores_onto_another_factorization(cross):
    """The {fsdp 2} checkpoint restored onto {tp 2}: every leaf as saved,
    and step 3 as on {fsdp 2}; the tp shards {tp 2} then saves assemble
    back into the same leaves."""
    results, _, out_dir, _, _ = cross
    assert _max_err(results["tp_restored"], results["port_saved"]["params"]) == 0.0
    loss, params = results["tp_step3"]
    port_loss, port_params = results["port_step3"]
    assert abs(loss - port_loss) < F32_TOL and _max_err(params, port_params) < STEP_TOL
    loaded = port_ckpt.load_pytree(str(out_dir / "port_ckpt_tp"))["params"]
    flat = {"/".join(path): leaf.numpy() for path, leaf in tree_leaves(loaded)}
    assert _max_err(flat, results["port_saved"]["params"]) == 0.0


def test_torn_save_is_refused_by_both_readers(cross):
    """A save whose DONE.p1 is missing: the port's reader and the
    reference's refuse it, each with the missing marker named."""
    from ray_tpu.train import checkpoint as jax_ckpt

    _, _, out_dir, _, _ = cross
    directory = _with_treedef(out_dir / "port_ckpt", out_dir / "torn")
    os.remove(directory / "DONE.p1")
    for verify in (port_ckpt.verify_sharded_checkpoint, jax_ckpt.verify_sharded_checkpoint):
        ok, reason = verify(str(directory))
        assert not ok and "DONE.p1" in reason
    with pytest.raises(IOError, match="DONE.p1"):
        port_ckpt.load_pytree(str(directory))
    with pytest.raises(IOError, match="DONE.p1"):
        jax_ckpt.load_pytree(str(directory))


def test_bf16_leaf_is_the_same_bytes_from_either_package(tmp_path):
    """One process saves {"a": bf16, "b": {"c.d": f32, "e": int32 scalar}}:
    the shard, index and manifest files are byte for byte the reference's,
    bf16 as raw 2-byte items ('<V2'), and the port reads the reference's."""
    import jax.numpy as jnp

    from ray_tpu.train import checkpoint as jax_ckpt

    rng = np.random.default_rng(4)
    a = rng.standard_normal((5, 7)).astype(np.float32)
    c = rng.standard_normal((3,)).astype(np.float32)
    jax_tree = {"a": jnp.asarray(a, jnp.bfloat16), "b": {"c.d": jnp.asarray(c),
                                                         "e": jnp.asarray(3, jnp.int32)}}
    port_tree = {"a": torch.from_numpy(a).to(torch.bfloat16),
                 "b": {"c.d": torch.from_numpy(c), "e": torch.tensor(3, dtype=torch.int32)}}
    jax_ckpt.save_pytree(str(tmp_path / "jax"), jax_tree)
    port_ckpt.save_pytree(str(tmp_path / "port"), port_tree)
    names = sorted(os.listdir(tmp_path / "jax" / "shards" / "p0"))
    assert names == sorted(os.listdir(tmp_path / "port" / "shards" / "p0"))
    assert "b.c%2Ed.s0.npy" in names
    for name in names + ["../../manifest.json"]:
        want = (tmp_path / "jax" / "shards" / "p0" / name).read_bytes()
        assert (tmp_path / "port" / "shards" / "p0" / name).read_bytes() == want, name
    assert b"'descr': '<V2'" in (tmp_path / "port" / "shards" / "p0" / "a.s0.npy").read_bytes()
    # Each reads the other's: the port with a template, JAX with treedef.pkl.
    loaded = port_ckpt.load_pytree(str(tmp_path / "jax"), port_tree)
    assert torch.equal(loaded["a"].view(torch.int16), port_tree["a"].view(torch.int16))
    assert torch.equal(loaded["b"]["c.d"], port_tree["b"]["c.d"]) and int(loaded["b"]["e"]) == 3
    # The reference cannot cast its own '<V2' shards back to bfloat16 (ROADMAP
    # Queue C item 8): it refuses the port's bf16 leaf as it refuses its own.
    shutil.copy(tmp_path / "jax" / "treedef.pkl", tmp_path / "port")
    for directory in ("jax", "port"):
        with pytest.raises(ValueError, match="No cast function"):
            jax_ckpt.load_pytree(str(tmp_path / directory))
    # Without a template the port rebuilds the structure from its tree.json.
    again = port_ckpt.load_pytree(str(tmp_path / "port"))
    assert set(again) == {"a", "b"} and set(again["b"]) == {"c.d", "e"}


@pytest.mark.parametrize("parts", [("a.b",), ("x/y", 0, "z%"), ("\\", "\x00"), ()])
def test_leaf_keys_are_the_references(parts):
    import jax.tree_util as jtu

    from ray_tpu.train import checkpoint as jax_ckpt

    path = tuple(jtu.SequenceKey(p) if isinstance(p, int) else jtu.DictKey(p) for p in parts)
    assert port_ckpt._leaf_key(parts) == jax_ckpt._leaf_key(path)


def _committable(path, value):
    port_ckpt.save_pytree(str(path), {"w": torch.full((4,), float(value))})
    return port_ckpt.Checkpoint(str(path))


def test_commit_protocol_keeps_num_to_keep_and_removes_torn_dirs(tmp_path):
    """persist stages, verifies, stamps and renames; retention keeps the
    newest num_to_keep; a new tracker removes a staging leftover and an
    uncommitted directory and returns the newest committed checkpoint."""
    from ray_tpu_torch.train.config import CheckpointConfig

    storage = port_ckpt.StorageContext(str(tmp_path / "runs"), "exp",
                                       checkpoint_config=CheckpointConfig(num_to_keep=2))
    for i in range(3):
        persisted = storage.persist(_committable(tmp_path / f"tmp{i}", i), {"step": i})
        assert port_ckpt.is_committed(persisted.path)
        assert not os.path.exists(tmp_path / f"tmp{i}")  # moved, not copied
    kept = [os.path.basename(c.path) for c, _ in storage.checkpoints()]
    assert kept == ["checkpoint_000001", "checkpoint_000002"]
    # A torn save is refused and leaves nothing behind.
    torn = _committable(tmp_path / "torn", 9)
    os.remove(os.path.join(torn.path, "DONE.p0"))
    os.makedirs(os.path.join(torn.path, "shards", "p1"))
    with pytest.raises(IOError, match="DONE"):
        storage.persist(torn, {})
    trial = storage.trial_dir
    os.makedirs(os.path.join(trial, "checkpoint_000007.staging"))
    shutil.copytree(os.path.join(trial, "checkpoint_000001"),
                    os.path.join(trial, "checkpoint_000008"))
    os.remove(os.path.join(trial, "checkpoint_000008", "COMMIT.json"))
    again = port_ckpt.StorageContext(str(tmp_path / "runs"), "exp",
                                     checkpoint_config=CheckpointConfig(num_to_keep=2))
    assert not os.path.exists(os.path.join(trial, "checkpoint_000007.staging"))
    assert not os.path.exists(os.path.join(trial, "checkpoint_000008"))
    latest = again.latest_checkpoint()
    assert os.path.basename(latest.path) == "checkpoint_000002"
    assert float(port_ckpt.load_pytree(latest.path)["w"][0]) == 2.0


def test_optimizer_state_takes_optax_key_paths():
    """AdamW's state maps onto optax.adamw's: the manifest keys of the
    port's tree are those of the reference's tree of the same model."""
    import jax
    import optax

    from ray_tpu.models import transformer as jt
    from ray_tpu.train import checkpoint as jax_ckpt

    config = pt.TransformerConfig.tiny()
    params = pt.init_params(config, 0, "cpu")
    opt = make_optimizer(params)
    port_keys = {port_ckpt._leaf_key(p) for p, _ in port_ckpt._flatten(
        {"params": params, "opt_state": convert.optax_adam_state(opt, params)})}
    jparams = jax.eval_shape(lambda: jt.init_params(jt.TransformerConfig.tiny(),
                                                    jax.random.PRNGKey(0)))
    jtree = {"params": jparams, "opt_state": jax.eval_shape(optax.adamw(3e-4).init, jparams)}
    jax_keys = {jax_ckpt._leaf_key(p) for p, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    assert port_keys == jax_keys and "opt_state.0.count" in port_keys
