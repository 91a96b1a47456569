from ray_tpu_torch.tune.search.basic_variant import BasicVariantGenerator, generate_variants
from ray_tpu_torch.tune.search.searcher import ConcurrencyLimiter, Searcher
from ray_tpu_torch.tune.search.tpe import TPESearch

__all__ = [
    "Searcher",
    "ConcurrencyLimiter",
    "BasicVariantGenerator",
    "generate_variants",
    "TPESearch",
]
