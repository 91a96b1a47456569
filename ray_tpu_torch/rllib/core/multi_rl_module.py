"""MultiRLModule — a dict of RLModules keyed by module id.

Port of ray_tpu's ``rllib/core/multi_rl_module.py``: holds one RLModule
per policy/module id; params are a dict tree {module_id: module_params}.
Agent→module routing happens in the runner via ``policy_mapping_fn`` —
the module itself is agnostic. The modules' params are drawn in turn from
one ``torch.Generator`` (sorted by module id), where the reference splits
one PRNG key.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ray_tpu_torch.rllib.core.rl_module import RLModule, RLModuleSpec, _generator


class MultiRLModuleSpec:
    """module_id → RLModuleSpec (or None for the default MLP catalog)."""

    def __init__(self, module_specs: Mapping[str, RLModuleSpec | None]):
        self.module_specs = {
            mid: (spec or RLModuleSpec()) for mid, spec in module_specs.items()
        }

    def build(
        self,
        observation_spaces: Mapping[str, object],
        action_spaces: Mapping[str, object],
        device=None,
    ) -> "MultiRLModule":
        modules = {
            mid: spec.build(observation_spaces[mid], action_spaces[mid], device=device)
            for mid, spec in self.module_specs.items()
        }
        return MultiRLModule(modules)


class MultiRLModule:
    def __init__(self, modules: Mapping[str, RLModule]):
        self._modules = dict(modules)

    def __getitem__(self, module_id: str) -> RLModule:
        return self._modules[module_id]

    def __contains__(self, module_id: str) -> bool:
        return module_id in self._modules

    def keys(self):
        return self._modules.keys()

    def items(self):
        return self._modules.items()

    def init_params(self, seed: int | torch.Generator = 0) -> dict:
        gen = _generator(seed)
        return {mid: module.init_params(gen) for mid, module in sorted(self._modules.items())}
