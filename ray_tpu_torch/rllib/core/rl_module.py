"""RLModule — the policy/value network, in PyTorch.

Port of ray_tpu's ``rllib/core/rl_module.py``: a function suite over a
params tree — ``forward_inference`` (greedy), ``forward_exploration``
(sample + logp), ``forward_train`` (logits + values), ``action_logp`` (the
loss's view) — so the learner updates the tree on its device and env
runners call the same functions on the CPU. The tree keeps the
reference's names and nesting (lists of ``{"w", "b"}`` layers); a tree of
the reference's goes through ``models.convert.rl_params_from_numpy``.

  * Dense weights are [in, out] (``x @ w + b``), as the reference's.
  * ``ConvModule``'s weights are OIHW ([out, in, kh, kw]) where the
    reference's are HWIO; its NHWC images are permuted to contiguous NCHW
    for ``F.conv2d`` (cuDNN on the card), VALID padding. The last conv's
    map is permuted back to NHWC before the flatten, so ``trunk[0]`` takes
    its rows in the reference's (h, w, c) order at any H x W.
    ``normalize_images`` casts uint8 to f32 on the module's device: the
    learner moves uint8 there, a quarter of f32's bytes.
  * ``LSTMModule``'s cell and its loop over time are written out: gates
    i, f, g, o from one bias, +1.0 on the forget gate inside the sigmoid,
    the state zeroed at each window's start and at the row after a done.
    (``nn.LSTM`` has two biases and no +1, and cuDNN's fused LSTM cannot
    reset the state inside a window.)
  * Initialisation draws the reference's distributions (He-normal dense
    and conv weights, zero biases) from a ``torch.Generator`` on the CPU,
    then moves the tree to the device, so a seed gives the same tree on
    every device. Sampling draws from the ``torch.Generator`` it is given,
    on the tensors' device. Neither reproduces JAX's threefry bits.

Every module takes ``device`` (cuda unless the caller asks for the CPU):
where ``init_params`` and ``initial_state`` put their tensors. The
forwards run on the device of the params and observations they are given.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.convert import _map

_LOG_2PI = math.log(2 * math.pi)


class RLModuleSpec:
    def __init__(self, module_class=None, model_config: dict | None = None):
        self.model_config = dict(model_config or {})
        if module_class is None:
            # Catalog selection (reference ModelCatalog: use_lstm flag,
            # conv_filters pick the vision net). Image-shaped observation
            # spaces also select the vision net, but the space is only
            # known at build() — module_class stays None until then.
            if self.model_config.get("use_lstm"):
                module_class = LSTMModule
            elif self.model_config.get("conv_filters"):
                module_class = ConvModule
        self.module_class = module_class

    def build(self, observation_space, action_space, device=None) -> "RLModule":
        module_class = self.module_class
        if module_class is None:
            shape = getattr(observation_space, "shape", None)
            # Image-SHAPED spaces go to the vision net only when the default
            # filter stack fits (min spatial dim >= 10 for the small stack);
            # tiny 3-D obs train through the MLP's flatten. Explicit
            # conv_filters always force ConvModule.
            module_class = (
                ConvModule
                if shape is not None and len(shape) == 3
                and min(int(shape[0]), int(shape[1])) >= 10
                else MLPModule
            )
        return module_class(observation_space, action_space, self.model_config, device=device)


class RLModule:
    """Stateless apart from construction metadata; params live outside."""

    def __init__(self, observation_space, action_space, model_config: dict, device=None):
        self.observation_space = observation_space
        self.action_space = action_space
        self.model_config = model_config
        self.device = resolve_device(device)

    def init_params(self, seed: int | torch.Generator = 0, device=None) -> Any:
        raise NotImplementedError

    def forward_train(self, params, obs) -> dict:
        """returns {"logits"| "mean/log_std", "vf"}"""
        raise NotImplementedError

    def forward_inference(self, params, obs) -> torch.Tensor:
        raise NotImplementedError

    def forward_exploration(self, params, obs, generator: torch.Generator) -> tuple:
        """returns (actions, logp, extra)"""
        raise NotImplementedError


def _generator(seed: int | torch.Generator) -> torch.Generator:
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(int(seed))


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * scale


def _mlp_init(gen: torch.Generator, sizes) -> list:
    return [{"w": _normal(gen, (n_in, n_out), math.sqrt(2.0 / n_in)), "b": torch.zeros(n_out)}
            for n_in, n_out in zip(sizes[:-1], sizes[1:])]


def _mlp_apply(layers, x, activation=torch.tanh):
    for layer in layers[:-1]:
        x = activation(x @ layer["w"] + layer["b"])
    last = layers[-1]
    return x @ last["w"] + last["b"]


def _to(tree, device):
    return _map(lambda leaf, _: leaf.to(device), tree)


def _gaussian_logp(actions, mean, log_std):
    std = torch.exp(log_std)
    return -0.5 * torch.sum(((actions - mean) / std) ** 2 + 2 * log_std + _LOG_2PI, dim=-1)


class MLPModule(RLModule):
    """Separate policy and value MLP towers (fcnet default: 2x256 tanh)."""

    def __init__(self, observation_space, action_space, model_config, device=None):
        super().__init__(observation_space, action_space, model_config, device)
        self.hiddens = tuple(model_config.get("fcnet_hiddens", (256, 256)))
        self.obs_dim = int(np.prod(observation_space.shape))
        self.discrete = hasattr(action_space, "n")
        if self.discrete:
            self.num_outputs = int(action_space.n)
        else:
            self.act_dim = int(np.prod(action_space.shape))
            self.num_outputs = 2 * self.act_dim  # mean + log_std

    def init_params(self, seed=0, device=None) -> dict:
        gen = _generator(seed)
        params = {
            "pi": _mlp_init(gen, (self.obs_dim, *self.hiddens, self.num_outputs)),
            "vf": _mlp_init(gen, (self.obs_dim, *self.hiddens, 1)),
        }
        return _to(params, device or self.device)

    def _heads(self, out, vf) -> dict:
        if self.discrete:
            return {"logits": out, "vf": vf}
        mean, log_std = torch.chunk(out, 2, dim=-1)
        return {"mean": mean, "log_std": torch.clamp(log_std, -20, 2), "vf": vf}

    def forward_train(self, params, obs) -> dict:
        obs = obs.reshape(obs.shape[0], -1).float()
        out = _mlp_apply(params["pi"], obs)
        vf = _mlp_apply(params["vf"], obs)[..., 0]
        return self._heads(out, vf)

    def _greedy(self, fwd):
        return torch.argmax(fwd["logits"], dim=-1) if self.discrete else fwd["mean"]

    def forward_inference(self, params, obs):
        return self._greedy(self.forward_train(params, obs))

    def _sample(self, fwd, generator) -> tuple:
        """(actions, logp, extra) drawn from the heads' distribution."""
        if self.discrete:
            logp_all = torch.log_softmax(fwd["logits"], dim=-1)
            actions = torch.multinomial(logp_all.exp(), 1, generator=generator)
            logp = torch.gather(logp_all, -1, actions)[:, 0]
            return actions[:, 0], logp, {"vf_preds": fwd["vf"]}
        mean, log_std = fwd["mean"], fwd["log_std"]
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
        actions = mean + torch.exp(log_std) * noise
        return actions, _gaussian_logp(actions, mean, log_std), {"vf_preds": fwd["vf"]}

    def forward_exploration(self, params, obs, generator):
        return self._sample(self.forward_train(params, obs), generator)

    def _logp_entropy(self, fwd, actions) -> tuple:
        if self.discrete:
            logp_all = torch.log_softmax(fwd["logits"], dim=-1)
            logp = torch.gather(logp_all, -1, actions[:, None].long())[:, 0]
            entropy = -torch.sum(torch.exp(logp_all) * logp_all, dim=-1)
            return logp, entropy, fwd["vf"]
        mean, log_std = fwd["mean"], fwd["log_std"]
        logp = _gaussian_logp(actions, mean, log_std)
        entropy = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1)
        return logp, entropy, fwd["vf"]

    def action_logp(self, params, obs, actions) -> tuple:
        """(logp(actions), entropy, vf) — used inside losses."""
        return self._logp_entropy(self.forward_train(params, obs), actions)


class ConvModule(MLPModule):
    """Vision net (reference: rllib/models :: ModelCatalog conv path /
    VisionNetwork): a shared conv trunk with a dense projection and
    separate pi/vf heads (the Atari-standard [[32,8,4],[64,4,2],[64,3,1]]
    + 512 trunk by default). See the module docstring for the layouts.

    model_config:
      conv_filters: [[out_channels, kernel, stride], ...] (VALID padding)
      conv_activation: "relu" (default) | "tanh"
      post_fcnet_hiddens: (512,) dense trunk after flatten
      normalize_images: True — scales uint8-style pixel obs by 1/255
        inside the forward, on the module's device.
    """

    def __init__(self, observation_space, action_space, model_config, device=None):
        super().__init__(observation_space, action_space, model_config, device)
        shape = observation_space.shape
        if len(shape) != 3:
            raise ValueError(f"ConvModule needs [H, W, C] observations, got {shape}")
        self.obs_shape = tuple(int(s) for s in shape)
        # Size-aware defaults (84x84 → the Atari stack).
        if min(self.obs_shape[0], self.obs_shape[1]) >= 60:
            default_filters = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
        else:
            default_filters = ((16, 4, 2), (32, 4, 2))
        self.filters = [tuple(int(x) for x in f)
                        for f in model_config.get("conv_filters", default_filters)]
        self.post_hiddens = tuple(model_config.get("post_fcnet_hiddens", (512,)))
        self.normalize = bool(model_config.get("normalize_images", True))
        self.activation = torch.tanh if model_config.get("conv_activation") == "tanh" else torch.relu
        # Flattened conv-out size from the VALID-padding shape recurrence.
        h, w = self.obs_shape[0], self.obs_shape[1]
        for _out, k, s in self.filters:
            h = (h - k) // s + 1
            w = (w - k) // s + 1
            if h <= 0 or w <= 0:
                raise ValueError(
                    f"conv_filters {self.filters} shrink {self.obs_shape} "
                    "below 1x1 — remove a layer or pad the observations"
                )
        self.conv_out_hw = (h, w)
        self.conv_out_dim = h * w * self.filters[-1][0]

    def init_params(self, seed=0, device=None) -> dict:
        gen = _generator(seed)
        convs = []
        in_ch = self.obs_shape[2]
        for out_ch, k, _s in self.filters:
            convs.append({"w": _normal(gen, (out_ch, in_ch, k, k), math.sqrt(2.0 / (k * k * in_ch))),
                          "b": torch.zeros(out_ch)})
            in_ch = out_ch
        trunk_sizes = (self.conv_out_dim, *self.post_hiddens)
        feat = trunk_sizes[-1]
        params = {
            "conv": convs,
            "trunk": _mlp_init(gen, trunk_sizes),
            "pi": _mlp_init(gen, (feat, self.num_outputs)),
            "vf": _mlp_init(gen, (feat, 1)),
        }
        return _to(params, device or self.device)

    def _features(self, params, obs):
        x = obs.permute(0, 3, 1, 2).contiguous().float()  # NHWC -> NCHW
        if self.normalize:
            x = x * (1.0 / 255.0)
        for layer, (_out, _k, s) in zip(params["conv"], self.filters):
            x = self.activation(F.conv2d(x, layer["w"], layer["b"], stride=s))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c) rows
        for layer in params["trunk"]:
            x = self.activation(x @ layer["w"] + layer["b"])
        return x

    def forward_train(self, params, obs) -> dict:
        feat = self._features(params, obs)
        out = _mlp_apply(params["pi"], feat)
        vf = _mlp_apply(params["vf"], feat)[..., 0]
        return self._heads(out, vf)


class LSTMModule(MLPModule):
    """Recurrent module (reference: model catalog ``use_lstm``): training
    runs the recurrence over fixed-length subsequences, a loop over time
    whose step takes every window at once; rollouts thread an explicit
    (h, c) state per env through ``forward_*`` (the env runner owns the
    state).

    Training-time state handling matches the reference's default
    zero-init-per-sequence simplification: the episode-contiguous batch
    is chopped into ``max_seq_len`` windows, each starting from zeros
    (no cross-window carryover); use PPO's sequence-preserving
    minibatcher so windows stay intact.
    """

    is_stateful = True

    def __init__(self, observation_space, action_space, model_config, device=None):
        super().__init__(observation_space, action_space, model_config, device)
        self.cell_size = int(model_config.get("lstm_cell_size", 128))
        self.max_seq_len = int(model_config.get("max_seq_len", 16))

    def init_params(self, seed=0, device=None) -> dict:
        gen = _generator(seed)
        hidden = self.hiddens[0] if self.hiddens else 128
        params = {
            "enc": _mlp_init(gen, (self.obs_dim, hidden)),
            "lstm": {
                "wx": _normal(gen, (hidden, 4 * self.cell_size), math.sqrt(1.0 / hidden)),
                "wh": _normal(gen, (self.cell_size, 4 * self.cell_size),
                              math.sqrt(1.0 / self.cell_size)),
                "b": torch.zeros(4 * self.cell_size),
            },
            "pi": _mlp_init(gen, (self.cell_size, self.num_outputs)),
            "vf": _mlp_init(gen, (self.cell_size, 1)),
        }
        return _to(params, device or self.device)

    # -- recurrence -----------------------------------------------------
    def initial_state(self, batch_size: int, device=None):
        zeros = torch.zeros(batch_size, self.cell_size, device=device or self.device)
        return (zeros, zeros)

    def _encode(self, params, obs):
        obs = obs.reshape(obs.shape[0], -1).float()
        return torch.tanh(_mlp_apply(params["enc"], obs))

    def _cell(self, params, x, state):
        h, c = state
        lstm = params["lstm"]
        gates = x @ lstm["wx"] + h @ lstm["wh"] + lstm["b"]
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, (h, c)

    def _lstm_heads(self, params, features) -> dict:
        out = _mlp_apply(params["pi"], features)
        vf = _mlp_apply(params["vf"], features)[..., 0]
        return self._heads(out, vf)

    def forward_train(self, params, obs, dones=None) -> dict:
        """[B, ...] episode-contiguous rows -> heads, the recurrence run
        over max_seq_len windows (zero state per window, padded tail).
        ``dones`` (row-aligned, done AT that step) resets the state at
        episode starts INSIDE a window — matching the rollout, which
        zeroes the per-env state after every done."""
        n = obs.shape[0]
        seq = self.max_seq_len
        pad = (-n) % seq
        x = self._encode(params, obs)
        dones_f = (x.new_zeros(n) if dones is None
                   else torch.as_tensor(dones, device=x.device).reshape(-1).float())
        # state entering step t is zeroed when step t-1 ended an episode
        starts = torch.cat([x.new_zeros(1), dones_f[:-1]])
        if pad:
            x = torch.cat([x, x.new_zeros(pad, x.shape[1])])
            starts = torch.cat([starts, x.new_zeros(pad)])
        windows = x.reshape(-1, seq, x.shape[1])  # [S, L, H]
        keep = (1.0 - starts.reshape(-1, seq))[..., None]  # [S, L, 1]
        state = self.initial_state(windows.shape[0], device=x.device)
        hs = []
        for t in range(seq):
            state = (state[0] * keep[:, t], state[1] * keep[:, t])
            h, state = self._cell(params, windows[:, t], state)
            hs.append(h)
        features = torch.stack(hs, dim=1).reshape(-1, self.cell_size)[:n]
        return self._lstm_heads(params, features)

    def action_logp(self, params, obs, actions, dones=None) -> tuple:
        """(logp, entropy, vf) with episode-reset-aware recurrence."""
        return self._logp_entropy(self.forward_train(params, obs, dones=dones), actions)

    # -- stateful rollout steps ----------------------------------------
    def _step(self, params, obs, state):
        if state is None:
            state = self.initial_state(obs.shape[0], device=obs.device)
        features, new_state = self._cell(params, self._encode(params, obs), state)
        return self._lstm_heads(params, features), new_state

    def forward_exploration(self, params, obs, generator, state=None):
        fwd, new_state = self._step(params, obs, state)
        return (*self._sample(fwd, generator), new_state)

    def forward_inference(self, params, obs, state=None):
        fwd, new_state = self._step(params, obs, state)
        return self._greedy(fwd), new_state
