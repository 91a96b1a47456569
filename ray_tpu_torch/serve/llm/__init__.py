"""ray_tpu_torch.serve.llm: throughput-first LLM serving on the port's
serve plane.

The port's copy of ray_tpu's ``serve/llm/``: continuous batching (a
resident decode loop over local channels that admits new sequences into
the running batch every iteration), disaggregated prefill and decode
pools with KV blocks crossing on the block-scaled quantized wire, the KV
pool in the decode replica's device memory, model multiplexing, and
autoscaling on the KV pool's headroom (``kv_headroom_min``).

Public surface::

    from ray_tpu_torch.serve import llm

    app = llm.build_llm_app(llm.LLMConfig(max_slots=64))
    serve.run(app, route_prefix="/llm")
"""

from ray_tpu_torch.serve.llm.batch import SequenceState, SlotBatch
from ray_tpu_torch.serve.llm.config import LLMConfig
from ray_tpu_torch.serve.llm.deployments import LLMDecode, LLMPrefill, build_llm_app
from ray_tpu_torch.serve.llm.engine import DecodeEngine
from ray_tpu_torch.serve.llm.kv import KVBlockPool
from ray_tpu_torch.serve.llm.wire import KVDeviceWire, decode_kv_blocks, encode_kv_blocks

__all__ = [
    "LLMConfig",
    "SlotBatch",
    "SequenceState",
    "KVBlockPool",
    "DecodeEngine",
    "KVDeviceWire",
    "encode_kv_blocks",
    "decode_kv_blocks",
    "LLMPrefill",
    "LLMDecode",
    "build_llm_app",
]
