"""Module-level trainables for the port's Tune tests
(``tests/test_torch_tune.py``, ``tests/test_torch_tuner.py``).

The port's trial processes import them by name; the reference's Tuner
pickles them by value. The function trainables and the trainer loop
report through whichever package's session is live in the process that
runs them, so one function runs under both Tuners. Every trainable is
deterministic: its metrics depend on its config and checkpoint alone.
"""

import os
import sys
import time

from ray_tpu.tune import trainable as ref_trainable
from ray_tpu_torch.tune import trainable as port_trainable


def _tune():
    """The Tune package whose function session is live here."""
    port = sys.modules.get("ray_tpu_torch.tune.trainable")
    if port is not None and port._current_session is not None:
        return port
    from ray_tpu.tune import trainable

    return trainable


def _train_report():
    """``report`` of the train session live here (a TorchTrainer's gang
    member or a JaxTrainer's worker)."""
    port = sys.modules.get("ray_tpu_torch.train.session")
    if port is not None and port.in_session():
        return port.report
    from ray_tpu.train import report

    return report


def slope(config):
    score = 0.0
    for _ in range(5):
        score += config["slope"]
        _tune().report({"score": score})


def quality(config):
    for step in range(1, 11):
        _tune().report({"score": config["quality"] * step})


def checkpointed(config):
    tune = _tune()
    ckpt = tune.get_checkpoint()
    start = ckpt["step"] if ckpt else 0
    for step in range(start, 3):
        tune.report({"step_done": step + 1}, checkpoint={"step": step + 1})


def flaky(config):
    tune = _tune()
    ckpt = tune.get_checkpoint()
    start = ckpt["step"] if ckpt else 0
    for step in range(start, 4):
        if step == 2 and not ckpt:
            raise RuntimeError("boom")
        tune.report({"step_done": step + 1}, checkpoint={"step": step + 1})


def scaled(config, offset):
    """For ``with_parameters``."""
    for step in range(1, 4):
        _tune().report({"score": offset + config["x"] * step})


class _CounterBody:
    def setup(self, config):
        self.count = 0
        self.step_size = config["step_size"]

    def step(self):
        self.count += self.step_size
        return {"count": self.count, "done": self.count >= 10 * self.step_size}

    def save_checkpoint(self):
        return {"count": self.count}

    def load_checkpoint(self, checkpoint):
        self.count = checkpoint["count"]


class RefCounter(_CounterBody, ref_trainable.Trainable):
    pass


class PortCounter(_CounterBody, port_trainable.Trainable):
    pass


class TensorCounter(port_trainable.Trainable):
    """Keeps its state in a CPU tensor and checkpoints the tensor itself:
    a restore in another process reads it after its saver has exited.
    Done when the state reaches ``stop_at`` (5); a step takes ``step_s``
    (0) seconds. At its third step, when it did not start from a
    checkpoint, ``fail_at_3`` "raise" raises and "exit" ends its process."""

    def setup(self, config):
        import torch

        self.state = torch.zeros(4)
        self.restored = False

    def step(self):
        fail = self.config.get("fail_at_3")
        if fail and not self.restored and self.state[0] == 2:
            if fail == "exit":
                os._exit(3)
            raise RuntimeError("boom at 3")
        time.sleep(self.config.get("step_s", 0))
        self.state += 1
        return {"value": float(self.state.sum()), "pid": os.getpid(),
                "done": bool(self.state[0] >= self.config.get("stop_at", 5))}

    def save_checkpoint(self):
        return {"state": self.state}

    def load_checkpoint(self, checkpoint):
        self.state = checkpoint["state"].clone()
        self.restored = True


def trainer_loop(config):
    """The loop of ``test_tuner_wraps_trainer``: the same under
    ``TorchTrainer`` and ``JaxTrainer``."""
    report = _train_report()
    for i in range(2):
        report({"loss": 1.0 / config.get("lr_scale", 1.0) / (i + 1)})


def pid_loop(config):
    """A TorchTrainer loop that reports its process (a gang member) each
    round; after round ``stall_after`` it sleeps, so that its trial cannot
    stop before the controller's kill."""
    from ray_tpu_torch.train import report

    stall_after = config.get("stall_after")
    for i in range(1, config.get("rounds", 6) + 1):
        report({"loss": config["lr"] * (7 - i), "pid": os.getpid()})
        if stall_after is not None and i >= stall_after:
            time.sleep(120)


def held(config):
    """Holds its resources ``hold_s`` seconds, then reports when it began
    and ended and the cards its process sees: the placement tests read the
    order of the trials from these. With ``meet_dir`` it first marks its
    start there and waits (up to 30 s) until ``meet`` trials have marked
    theirs; ``met`` says whether they did, so trials that ran at once show
    it however slowly their processes started."""
    began = time.time()
    met = None
    if config.get("meet_dir"):
        open(os.path.join(config["meet_dir"], str(os.getpid())), "w").close()
        deadline = time.time() + 30.0
        while len(os.listdir(config["meet_dir"])) < config["meet"] and time.time() < deadline:
            time.sleep(0.02)
        met = len(os.listdir(config["meet_dir"])) >= config["meet"]
    time.sleep(config.get("hold_s", 0.5))
    _tune().report({"began": began, "ended": time.time(), "pid": os.getpid(),
                    "visible": os.environ.get("CUDA_VISIBLE_DEVICES"), "met": met})
