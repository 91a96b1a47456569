"""Actor classes that chip_smoke.py's phase 28 compiles into graphs
(``ray_tpu_torch.dag``), and the CPU tests with it.

* ``TransformerStage``: one pipeline stage of the transformer
  (``models.transformer.stage_forward``). It builds its half of the tree
  from the seed the driver's tree came from (``init_params``, then
  ``partition_stages``) and keeps that half alone, or takes its tree as
  numpy arrays (the CPU tests' JAX parameters). Its ``echo`` is the hop
  benchmark's stage and ``pingpong`` the raw side's peer.
* ``Relay``: ``release/benchmarks_dag.py``'s and
  ``release/benchmarks_dag_recovery.py``'s ``add`` actor.

Actor processes import these by module and name, so they live here at
module level. ``Relay`` imports nothing but the standard library: a relay
actor starts without torch.
"""

from __future__ import annotations

import os
import time


def kernel_counts() -> tuple[dict, dict]:
    """(launches by kernel, flash launches by route) of the port's kernel
    wrappers in this process, under chip_smoke.py's kernel names."""
    from ray_tpu_torch.ops import flash_attention as flash
    from ray_tpu_torch.ops import rmsnorm

    fns = {"flash_attention_fwd": flash.flash_attention,
           "flash_attention_bwd_dq": flash._flash_bwd_dq,
           "flash_attention_bwd_dkv": flash._flash_bwd_dkv}
    counts = {name: fn.launches for name, fn in fns.items()}
    counts["rmsnorm"] = rmsnorm.rmsnorm.launches
    counts["rmsnorm_bwd"] = rmsnorm.rmsnorm_backward.launches
    return counts, {name: dict(fn.launches_by_route) for name, fn in fns.items()}


# Words a checksum widens to int64 at once (512 MB).
_CHECKSUM_CHUNK = 1 << 26


def leaf_checksums(tree) -> dict:
    """An exact checksum of each leaf: the int64 sum and sum of squares of
    its bytes read as int16 words (integer sums do not depend on order),
    taken a chunk at a time."""
    import torch

    from ray_tpu_torch.train.step import named_leaves

    out = {}
    for name, leaf in named_leaves(tree):
        words = leaf.detach().contiguous().reshape(-1).view(torch.int16)
        total = squares = 0
        for start in range(0, words.numel(), _CHECKSUM_CHUNK):
            chunk = words[start:start + _CHECKSUM_CHUNK].to(torch.int64)
            total += int(chunk.sum())
            squares += int(chunk.square().sum())
        out[name] = (total, squares)
    return out


class TransformerStage:
    """Stage ``stage`` of ``num_stages`` of ``TransformerConfig(**config)``.

    With ``seed``, builds the whole tree on ``device`` and keeps a copy of
    its half (the rest is freed before the first call); with ``tree``,
    takes its half as numpy arrays. ``last_position`` makes the last stage
    return only the last position's logits, [batch, vocab]."""

    def __init__(self, config: dict, stage: int, num_stages: int, *, seed: int | None = None,
                 tree: dict | None = None, device: str = "cuda", last_position: bool = False):
        import torch

        from ray_tpu_torch.models import transformer
        from ray_tpu_torch.models.convert import params_from_numpy
        from ray_tpu_torch.parallel.mesh import tree_map

        started = time.time()
        self.config = transformer.TransformerConfig(**config)
        self.first, self.last = stage == 0, stage == num_stages - 1
        self.last_position = last_position
        self.device = device
        if tree is None:
            whole = transformer.init_params(self.config, seed=seed, device=device)
            self.params = tree_map(lambda t: t.clone(),
                                   transformer.partition_stages(whole, self.config,
                                                                num_stages)[stage])
            del whole
        else:
            self.params = params_from_numpy(tree, device=device, dtype=self.config.dtype)
        self.peak_bytes = 0
        if device == "cuda":
            torch.cuda.synchronize()
            self.peak_bytes = torch.cuda.max_memory_allocated()
            torch.cuda.empty_cache()
        self.ready_s = time.time() - started

    def forward(self, x):
        import torch

        from ray_tpu_torch.models.transformer import stage_forward

        with torch.inference_mode():
            out = stage_forward(self.params, x, self.config, first=self.first, last=self.last)
            if self.last and self.last_position:
                out = out[:, -1, :].contiguous()
        return out

    def echo(self, x):
        return x

    def info(self) -> dict:
        """Start, memory and the card this actor sees."""
        import torch

        info = {"pid": os.getpid(), "ready_s": self.ready_s,
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "peak_bytes": self.peak_bytes,
                "stage_bytes": sum(t.numel() * t.element_size()
                                   for t in _leaves(self.params))}
        if self.device == "cuda":
            info.update(allocated=torch.cuda.memory_allocated(),
                        device_index=torch.cuda.current_device(),
                        device_name=torch.cuda.get_device_name(),
                        uuid=str(getattr(torch.cuda.get_device_properties(0), "uuid", "")))
        return info

    def checksums(self) -> dict:
        return leaf_checksums(self.params)

    def reset_counts(self) -> None:
        from ray_tpu_torch.ops import flash_attention, rmsnorm

        flash_attention.reset_launch_counts()
        rmsnorm.rmsnorm.launches = 0
        rmsnorm.rmsnorm_backward.launches = 0

    def counts(self) -> tuple[dict, dict]:
        return kernel_counts()

    def pingpong(self, port: int, name: str, nbytes: int, reps: int, cuda: bool) -> dict:
        """Rank 1 of a two-rank ping-pong that the driver (rank 0) leads on
        a ``DeviceGroup``: the raw side of the hop benchmark. Host: a float32
        tensor echoed by gloo send/recv; CUDA: the same IPC exchange a device
        edge makes (frame, open, event wait, copy, ACK) with no stage loop,
        mailbox or seq around it."""
        import torch

        from ray_tpu_torch.dag import channels

        group = channels.DeviceGroup(channels.join_store(port), name, 1, 2)
        elems = nbytes // 4
        if cuda:
            cache: dict = {}
            for _ in range(reps):
                _, body = group.recv_frame(0, 1)
                value, dec = channels.decode(group, 0, body, cache)
                for done in dec.copies:
                    done.synchronize()
                group.send_frame(0, 2, channels.ACK)
                reply, held, _ = channels.encode(group, 0, value)
                group.send_frame(0, 1, channels.VALUE, reply)
                group.recv_frame(0, 2)  # the driver's ACK: our copy may go
        else:
            buf = torch.empty(elems, dtype=torch.float32)
            for _ in range(reps):
                group.gloo.recv([buf], 0, 1).wait()
                group.gloo.send([buf], 0, 1).wait()
        return {"reps": reps}


def _leaves(tree):
    from ray_tpu_torch.train.step import named_leaves

    return [leaf for _, leaf in named_leaves(tree)]


class Relay:
    """``add(x) = x + 1``: the release DAG benchmarks' stage."""

    def add(self, x):
        return x + 1
