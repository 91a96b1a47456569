"""The port's CNN and ResNet (``ray_tpu_torch/models/cnn.py``) against the
JAX package's (``ray_tpu/models/cnn.py``), f32 on the CPU.

Parameters come from the JAX init and go through
``convert.conv_params_from_numpy`` (HWIO to OIHW, the CNN's dense rows
from (h, w, c) to (c, h, w) order); gradients come back through
``conv_params_to_numpy``. Images and labels are made with numpy from a
seed. The CNN runs at ``CNNConfig()`` (Fashion-MNIST: 28 x 28 x 1, 10
classes); the ResNet at width 8 on 16 x 16 x 3 images with one and two
blocks a stage, whose first strided block holds a projection, and on a
hand-built tree whose strided block has none (the reference's
``x[:, ::s, ::s, :]`` shortcut, which its own init never builds). Bounds
as ROADMAP's parity rules set them for f32: logits and losses at 2e-5,
each gradient at 2e-4, max |port - JAX| over the value's largest
magnitude where that exceeds 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ray_tpu.models import cnn as jc
from ray_tpu_torch.models import cnn as pc
from ray_tpu_torch.models.convert import conv_params_from_numpy, conv_params_to_numpy
from ray_tpu_torch.train.step import named_leaves

F32_TOL = 2e-5
GRAD_F32_TOL = 2e-4
RESNET_BLOCKS = [(1, 1), (2, 2)]


def _err(port, ref) -> float:
    """max |port - ref| over max(1, max |ref|)."""
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref, np.float32)
    return float(np.max(np.abs(port - ref)) / max(1.0, float(np.max(np.abs(ref)))))


def _data(batch, size, channels, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch, size, size, channels)).astype(np.float32)
    return images, rng.integers(0, 10, batch).astype(np.int32)


def _check(jax_loss, port_loss, jparams, jconfig, pconfig, images, labels):
    """The loss, the accuracy and every gradient leaf against JAX."""
    (ref_loss, ref_acc), ref_grads = jax.value_and_grad(jax_loss, has_aux=True)(
        jparams, jnp.asarray(images), jnp.asarray(labels), jconfig)
    params = conv_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    names, leaves = zip(*named_leaves(params))
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss, acc = port_loss(params, torch.from_numpy(images), torch.from_numpy(labels), pconfig)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss.detach()) - float(ref_loss)) < F32_TOL
    assert float(acc) == float(ref_acc)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    port_grads = conv_params_to_numpy(_named_map(lambda name: grads[name], params))
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    flat_port = dict(jax.tree_util.tree_flatten_with_path(port_grads)[0])
    assert len(flat_ref) == len(flat_port)
    for path, ref in flat_ref:
        assert float(np.max(np.abs(np.asarray(ref)))) > 0, path
        assert _err(flat_port[path], ref) < GRAD_F32_TOL, path


def _named_map(fn, tree, prefix=""):
    """fn(dotted name) over a tree of dicts and lists, named as
    ``named_leaves`` names its leaves."""
    if isinstance(tree, dict):
        return {k: _named_map(fn, v, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_named_map(fn, v, f"{prefix}{i}.") for i, v in enumerate(tree)]
    return fn(prefix[:-1])


def test_cnn_forward_matches_jax():
    jconfig, pconfig = jc.CNNConfig(), pc.CNNConfig()
    jparams = jc.init_cnn(jconfig, jax.random.PRNGKey(0))
    images, _ = _data(4, 28, 1)
    ref = jc.cnn_forward(jparams, jnp.asarray(images), jconfig)
    params = conv_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    with torch.no_grad():
        out = pc.cnn_forward(params, torch.from_numpy(images), pconfig)
    assert out.shape == (4, 10) and out.dtype == torch.float32
    assert _err(out, ref) < F32_TOL


def test_cnn_loss_and_gradients_match_jax():
    jconfig = jc.CNNConfig()
    images, labels = _data(4, 28, 1, seed=1)
    _check(jc.cnn_loss, pc.cnn_loss, jc.init_cnn(jconfig, jax.random.PRNGKey(0)), jconfig,
           pc.CNNConfig(), images, labels)


@pytest.mark.parametrize("blocks", RESNET_BLOCKS, ids=["blocks_1_1", "blocks_2_2"])
def test_resnet_forward_matches_jax(blocks):
    jconfig = jc.ResNetConfig(width=8, blocks_per_stage=blocks, image_size=16)
    pconfig = pc.ResNetConfig(width=8, blocks_per_stage=blocks, image_size=16)
    jparams = jc.init_resnet(jconfig, jax.random.PRNGKey(0))
    assert "proj" in jparams["stages"][1][0]
    images, _ = _data(2, 16, 3)
    ref = jc.resnet_forward(jparams, jnp.asarray(images), jconfig)
    params = conv_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    with torch.no_grad():
        out = pc.resnet_forward(params, torch.from_numpy(images), pconfig)
    assert out.shape == (2, 10)
    assert _err(out, ref) < F32_TOL


@pytest.mark.parametrize("blocks", RESNET_BLOCKS, ids=["blocks_1_1", "blocks_2_2"])
def test_resnet_loss_and_gradients_match_jax(blocks):
    jconfig = jc.ResNetConfig(width=8, blocks_per_stage=blocks, image_size=16)
    images, labels = _data(2, 16, 3, seed=2)
    _check(jc.resnet_loss, pc.resnet_loss, jc.init_resnet(jconfig, jax.random.PRNGKey(0)),
           jconfig, pc.ResNetConfig(width=8, blocks_per_stage=blocks, image_size=16),
           images, labels)


def _strided_identity_tree(channels=8, seed=3):
    """A two-stage ResNet tree whose strided block (stage 1, block 0) keeps
    its channels and holds no projection, in the reference's layout."""
    rng = np.random.default_rng(seed)

    def conv(cin, cout):
        return {"w": (rng.standard_normal((3, 3, cin, cout)) * np.sqrt(2 / (9 * cin))
                      ).astype(np.float32),
                "b": (rng.standard_normal(cout) * 0.1).astype(np.float32)}

    block = lambda: {"conv1": conv(channels, channels), "conv2": conv(channels, channels)}
    return {"stem": conv(3, channels), "stages": [[block()], [block()]],
            "head": {"w": rng.standard_normal((channels, 10)).astype(np.float32),
                     "b": np.zeros(10, np.float32)}}


def test_resnet_strided_identity_shortcut_matches_jax():
    jconfig = jc.ResNetConfig(width=8, blocks_per_stage=(1, 1), image_size=16)
    pconfig = pc.ResNetConfig(width=8, blocks_per_stage=(1, 1), image_size=16)
    tree = _strided_identity_tree()
    images, labels = _data(2, 16, 3, seed=4)
    jparams = jax.tree.map(jnp.asarray, tree)
    ref = jc.resnet_forward(jparams, jnp.asarray(images), jconfig)
    with torch.no_grad():
        out = pc.resnet_forward(conv_params_from_numpy(tree, device="cpu"),
                                torch.from_numpy(images), pconfig)
    assert _err(out, ref) < F32_TOL
    _check(jc.resnet_loss, pc.resnet_loss, jparams, jconfig, pconfig, images, labels)


def test_strided_same_conv_pads_after_only():
    """A stride-2 3x3 SAME conv on an even input pads 0 before and 1 after:
    the port's equals JAX's, and conv2d(padding=1) gives another result."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    ref = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    p = conv_params_from_numpy({"conv": {"w": w, "b": b}}, device="cpu")["conv"]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    out = pc._conv(xt, p, stride=2).permute(0, 2, 3, 1)
    assert pc._same_padding(8, 3, 2) == (0, 1)
    assert _err(out, ref) < F32_TOL
    symmetric = F.conv2d(xt, p["w"], p["b"], stride=2, padding=1).permute(0, 2, 3, 1)
    assert symmetric.shape == out.shape
    assert _err(symmetric, ref) > 0.1


@pytest.mark.parametrize("size,kernel,stride,want", [
    (28, 3, 1, (1, 1)), (32, 3, 2, (0, 1)), (7, 3, 2, (1, 1)), (32, 1, 2, (0, 0)),
    (5, 1, 1, (0, 0)),
])
def test_same_padding_is_xlas(size, kernel, stride, want):
    assert pc._same_padding(size, kernel, stride) == want


def test_conversion_round_trips_and_init_shapes_match():
    for jtree, ptree in (
            (jc.init_cnn(jc.CNNConfig(), jax.random.PRNGKey(0)),
             pc.init_cnn(pc.CNNConfig(), 0, device="cpu")),
            (jc.init_resnet(jc.ResNetConfig(width=8), jax.random.PRNGKey(0)),
             pc.init_resnet(pc.ResNetConfig(width=8), 0, device="cpu"))):
        tree = jax.tree.map(np.asarray, jtree)
        back = conv_params_to_numpy(conv_params_from_numpy(tree, device="cpu"))
        jax.tree.map(np.testing.assert_array_equal, back, tree)
        ported = conv_params_from_numpy(tree, device="cpu")
        assert jax.tree.map(lambda t: tuple(t.shape), ported) == jax.tree.map(
            lambda t: tuple(t.shape), ptree)


def test_entry_points_need_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pc.init_cnn(pc.CNNConfig(), 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pc.init_resnet(pc.ResNetConfig(), 0)
