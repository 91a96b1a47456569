"""ray_tpu_torch.tune — hyperparameter search (Ray Tune-equivalent).

Entry points mirror ray.tune: Tuner(...).fit() → ResultGrid, tune.run(...),
search-space constructors (uniform/choice/grid_search/...), schedulers
(ASHA/HyperBand/PBT/median-stopping), searchers (grid/random, Optuna
adapter), function trainables with tune.report(), class Trainables, and
experiment resume via Tuner.restore(). SURVEY §2.5.

Port of ray_tpu's ``tune/``, with the reference's exports. Search and
scheduling are plain Python over ``random.Random``, copied so that one
seed gives the same draws and decisions in both packages. Trials are
runtime actors (``execution/tune_controller.py``; ``Tuner.fit()`` needs
``ray_tpu_torch.init()``), leasing ``{"CPU": 1}`` or what
``with_resources`` asks; a trial is a function or class trainable, or a
``TorchTrainer`` on its gang. Left out, each in ROADMAP Queue A item 1
with its reason: multi-host trials, Optuna and TensorBoard where they are
not installed, and trial actors kept for reuse (``reuse_actors``).
"""

from ray_tpu_torch.tune.result_grid import ResultGrid, TrialResult
from ray_tpu_torch.tune.search.sample import (
    choice,
    grid_search,
    lograndint,
    loguniform,
    quniform,
    randint,
    randn,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.trainable import (
    Trainable,
    get_checkpoint,
    report,
    with_parameters,
    with_resources,
    wrap_function,
)
from ray_tpu_torch.tune.tuner import TuneConfig, Tuner, run

__all__ = [
    "Tuner",
    "TuneConfig",
    "run",
    "ResultGrid",
    "TrialResult",
    "Trainable",
    "report",
    "get_checkpoint",
    "with_parameters",
    "with_resources",
    "wrap_function",
    "uniform",
    "loguniform",
    "quniform",
    "randint",
    "lograndint",
    "choice",
    "randn",
    "sample_from",
    "grid_search",
]
