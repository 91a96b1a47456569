"""Compiled graphs across cards (``ray_tpu_torch.dag``): marked ``cuda``,
for a machine with two or more NVIDIA cards (such as a four-card H100
machine); each test skips here, with its reason, where there are fewer.

A two-stage graph of ``TransformerConfig.tiny()`` (f32) whose stage actors
each lease a whole card from the host's ledger: the driver's tokens reach
stage 0 as a CUDA IPC handle (the driver sees its card), the hidden state
crosses from card 0 to card 1 over NCCL send/recv (no IPC to another card,
and never through the host), and the logits come back to the driver by
IPC. Held against the one-process ``stage_forward`` chain on the driver's
first card, bitwise or within TINY_TOL. No JAX here: the reference is the
port's own plain chain.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ray_tpu_torch._private import dag_apps, local_tasks
from ray_tpu_torch.dag import InputNode
from ray_tpu_torch.models import transformer as pt

# f32 logits of the tiny model: the same kernels on two cards of one kind;
# chip_smoke.py's TINY_LOGITS_TOL.
TINY_TOL = 2e-5


@pytest.mark.cuda
def test_two_stage_graph_across_cards_over_nccl():
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs 2 CUDA cards, found {torch.cuda.device_count()}")
    from ray_tpu_torch import _build

    _build.library()  # built once here, loaded by each stage actor
    config = pt.TransformerConfig.tiny()
    fields = {f.name: getattr(config, f.name) for f in dataclasses.fields(config)}
    stage_cls = local_tasks.remote(dag_apps.TransformerStage).options(num_gpus=1)
    stages = [stage_cls.remote(fields, s, 2, seed=0, device="cuda", last_position=True)
              for s in range(2)]
    try:
        infos = local_tasks.get([s.info.remote() for s in stages], timeout=300)
        assert [i["visible"] for i in infos] == ["0", "1"]
        assert infos[0]["uuid"] != infos[1]["uuid"]
        params = pt.init_params(config, seed=0, device="cuda")
        parts = pt.partition_stages(params, config, 2)
        assert local_tasks.get([s.checksums.remote() for s in stages], timeout=120) == \
            [dag_apps.leaf_checksums(p) for p in parts]
        with InputNode() as inp:
            out = stages[1].forward.bind(stages[0].forward.bind(inp))
        dag = out.experimental_compile(channel="device")
        rng = np.random.default_rng(5)
        inputs = [torch.from_numpy(rng.integers(0, config.vocab_size, (4, 32))).cuda()
                  for _ in range(6)]
        try:
            refs = [dag.execute(t) for t in inputs]
            got = [r.get(timeout=300) for r in refs]
        finally:
            dag.close()
        with torch.inference_mode():
            for tokens, logits in zip(inputs, got):
                x = tokens
                for s, tree in enumerate(parts):
                    x = pt.stage_forward(tree, x, config, first=s == 0, last=s == 1)
                want = x[:, -1, :].cpu()
                # The logits arrive on the card stage 1 made them on.
                assert logits.device == torch.device("cuda", 1) and logits.shape == want.shape
                logits = logits.cpu()
                assert torch.equal(logits, want) or \
                    float((logits - want).abs().max()) < TINY_TOL
    finally:
        local_tasks.shutdown()
