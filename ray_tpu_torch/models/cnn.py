"""Small conv nets: the Fashion-MNIST CNN and the compact ResNet, in
PyTorch.

Port of ray_tpu's ``models/cnn.py`` (BASELINE configs 1 and 3:
``release/train_fashion_mnist.py`` and ``release/tune_asha_resnet.py``).
The entry points take images as the reference does, [batch, height,
width, channels], and run contiguous NCHW: the images are permuted and
copied once. (The permuted view alone is an NCHW tensor in
``channels_last`` memory; on the CPU, PyTorch 2.13's oneDNN convolution
backward crashed on it now and then, with a segfault or an abort, and
never on the copy.) Convolutions are ``torch.nn.functional.conv2d``
(cuDNN on the card), as the reference's are XLA's
``conv_general_dilated``: no Pallas kernel stands behind them.

The parameter tree keeps the reference's names and nesting (lists for
``convs`` and ``stages``); conv weights are OIHW ([out, in, kh, kw]), and
the CNN's dense weight takes its rows in (channels, height, width) order,
the order an NCHW activation flattens in. ``models/convert.py`` transposes
the reference's HWIO weights and permutes the dense rows, which it
flattens in (height, width, channels) order.

  * ``padding="SAME"`` pads ``total = max((ceil(n / s) - 1) * s + k - n,
    0)`` with ``total // 2`` before and the rest after: a stride-2 3x3 conv
    on an even input pads 0 before and 1 after, which ``conv2d(padding=1)``
    does not do, so such a conv pads explicitly first.
  * Max pooling is the reference's ``reduce_window`` (-inf init, 2x2,
    stride 2, VALID): ``max_pool2d`` with its floor mode.
  * A strided block without a projection takes ``x[:, :, ::s, ::s]`` as its
    shortcut, the reference's ``x[:, ::s, ::s, :]``.
  * The losses are the reference's: an f32 log-softmax, the mean NLL, and
    the accuracy of the argmax.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from ray_tpu_torch import resolve_device


@dataclasses.dataclass
class CNNConfig:
    num_classes: int = 10
    channels: Sequence[int] = (32, 64)
    hidden: int = 128
    in_channels: int = 1
    image_size: int = 28
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass
class ResNetConfig:
    num_classes: int = 10
    width: int = 64
    blocks_per_stage: Sequence[int] = (2, 2, 2, 2)  # ResNet-18 layout
    in_channels: int = 3
    image_size: int = 32
    dtype: torch.dtype = torch.float32


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _normal(gen, shape, scale, dtype, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * scale).to(dtype)


def _conv_init(gen, kh, kw, cin, cout, dtype, device) -> dict:
    """He-normal OIHW weight (the reference's scale, sqrt(2 / (kh kw cin)))
    and a zero bias."""
    return {"w": _normal(gen, (cout, cin, kh, kw), math.sqrt(2.0 / (kh * kw * cin)), dtype,
                         device),
            "b": torch.zeros(cout, dtype=dtype, device=device)}


def _dense_init(gen, fan_in, fan_out, dtype, device) -> dict:
    return {"w": _normal(gen, (fan_in, fan_out), math.sqrt(2.0 / fan_in), dtype, device),
            "b": torch.zeros(fan_out, dtype=dtype, device=device)}


def init_cnn(config: CNNConfig, seed: int, device=None) -> dict:
    """Random CNN parameters from a seeded ``torch.Generator``: the
    reference's distributions and scales (not its bits)."""
    device = resolve_device(device)
    gen = _generator(seed, device)
    convs, cin = [], config.in_channels
    for cout in config.channels:
        convs.append(_conv_init(gen, 3, 3, cin, cout, config.dtype, device))
        cin = cout
    spatial = config.image_size // (2 ** len(config.channels))
    return {"convs": convs,
            "dense": _dense_init(gen, spatial * spatial * cin, config.hidden, config.dtype,
                                 device),
            "out": _dense_init(gen, config.hidden, config.num_classes, config.dtype, device)}


def init_resnet(config: ResNetConfig, seed: int, device=None) -> dict:
    """Random ResNet parameters from a seeded ``torch.Generator``; a block
    whose channels change holds a 1x1 projection ``proj``."""
    device = resolve_device(device)
    gen = _generator(seed, device)
    dt = config.dtype
    params = {"stem": _conv_init(gen, 3, 3, config.in_channels, config.width, dt, device),
              "stages": []}
    cin = config.width
    for stage, blocks in enumerate(config.blocks_per_stage):
        cout = config.width * (2 ** stage)
        stage_params = []
        for _ in range(blocks):
            block = {"conv1": _conv_init(gen, 3, 3, cin, cout, dt, device),
                     "conv2": _conv_init(gen, 3, 3, cout, cout, dt, device)}
            if cin != cout:
                block["proj"] = _conv_init(gen, 1, 1, cin, cout, dt, device)
            stage_params.append(block)
            cin = cout
        params["stages"].append(stage_params)
    params["head"] = _dense_init(gen, cin, config.num_classes, dt, device)
    return params


def _same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(before, after) of ``padding="SAME"`` along one spatial dim."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, p: dict, stride: int = 1) -> torch.Tensor:
    """The reference's SAME convolution plus bias, NCHW."""
    kh, kw = p["w"].shape[2:]
    top, bottom = _same_padding(x.shape[2], kh, stride)
    left, right = _same_padding(x.shape[3], kw, stride)
    if top == bottom and left == right:
        return F.conv2d(x, p["w"], p["b"], stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), p["w"], p["b"], stride=stride)


def _nchw(images) -> torch.Tensor:
    """[B, H, W, C] images as a contiguous NCHW tensor."""
    return torch.as_tensor(images).permute(0, 3, 1, 2).contiguous()


def cnn_forward(params: dict, images, config: CNNConfig) -> torch.Tensor:
    """images: [B, H, W, C] -> logits [B, num_classes]."""
    x = _nchw(images)
    for conv in params["convs"]:
        x = F.max_pool2d(F.relu(_conv(x, conv)), kernel_size=2, stride=2)
    x = x.reshape(x.shape[0], -1)  # (C, H, W) order: the dense rows' order
    x = F.relu(x @ params["dense"]["w"] + params["dense"]["b"])
    return x @ params["out"]["w"] + params["out"]["b"]


def resnet_forward(params: dict, images, config: ResNetConfig) -> torch.Tensor:
    """images: [B, H, W, C] -> logits [B, num_classes]."""
    x = F.relu(_conv(_nchw(images), params["stem"]))
    for stage_idx, stage in enumerate(params["stages"]):
        for block_idx, block in enumerate(stage):
            stride = 2 if (stage_idx > 0 and block_idx == 0) else 1
            shortcut = x
            h = F.relu(_conv(x, block["conv1"], stride))
            h = _conv(h, block["conv2"])
            if "proj" in block:
                shortcut = _conv(shortcut, block["proj"], stride)
            elif stride != 1:
                shortcut = shortcut[:, :, ::stride, ::stride]
            x = F.relu(h + shortcut)
    x = x.mean(dim=(2, 3))
    return x @ params["head"]["w"] + params["head"]["b"]


def _loss_and_accuracy(logits: torch.Tensor, labels) -> tuple[torch.Tensor, torch.Tensor]:
    labels = torch.as_tensor(labels, device=logits.device).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    loss = -logp.gather(-1, labels[:, None]).mean()
    accuracy = (logits.argmax(-1) == labels).float().mean()
    return loss, accuracy


def cnn_loss(params: dict, images, labels, config: CNNConfig):
    """(mean NLL, accuracy) of the CNN on a labelled batch."""
    return _loss_and_accuracy(cnn_forward(params, images, config), labels)


def resnet_loss(params: dict, images, labels, config: ResNetConfig):
    """(mean NLL, accuracy) of the ResNet on a labelled batch."""
    return _loss_and_accuracy(resnet_forward(params, images, config), labels)
