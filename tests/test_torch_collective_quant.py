"""The port's block-scaled wire codec (``ray_tpu_torch.util.collective.
quantization``) against the reference's (``ray_tpu/util/collective/
quantization.py``): the same bits for the same inputs, from the numpy
plain version and from the torch codec on CPU tensors (the card's path runs
the same operations; chip_smoke.py phase 29 holds it there), the same
error-feedback trajectories, and the same validation.

The reference's fp8 goes through ml_dtypes' float8_e4m3fn; the port's
through torch's, with its payload as uint8 bits: the tests compare bits.
"""

import numpy as np
import pytest
import torch

from ray_tpu.util.collective import quantization as ref_q
from ray_tpu_torch.util.collective import quantization as port_q

KINDS = ["int8", "fp8"]


def _inputs(case: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if case == "normal":
        return rng.standard_normal(n).astype(np.float32)
    if case == "zeros":  # all-zero blocks beside live ones
        x = rng.standard_normal(n).astype(np.float32)
        x[: n // 2] = 0.0
        return x
    # Mixed magnitudes, 1e-30 to 1e30, with a zero block at the start.
    x = (rng.standard_normal(n) * 10.0 ** rng.uniform(-30, 30, n)).astype(np.float32)
    x[:256] = 0.0
    return x


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _same_encoding(ref, got) -> None:
    assert got[0] == ref[0] and got[3] == ref[3]
    assert np.array_equal(_bits(got[1]), _bits(ref[1]))
    assert got[2].dtype == np.float32 and np.array_equal(_bits(got[2]), _bits(ref[2]))


def _check(x: np.ndarray, kind: str, block: int) -> None:
    ref_cfg = ref_q.CollectiveConfig(quantize=kind, block_size=block)
    cfg = port_q.CollectiveConfig(quantize=kind, block_size=block)
    ref = ref_q.encode(x, ref_cfg)
    want = _bits(ref_q.decode(ref))
    for got in (port_q.encode_plain(x, cfg), port_q.encode(torch.from_numpy(x.copy()), cfg)):
        _same_encoding(ref, got)
        assert np.array_equal(_bits(port_q.decode(got)), want)
        assert np.array_equal(_bits(port_q.decode_device(got, "cpu").numpy()), want)
        assert port_q.wire_nbytes(got) == ref_q.wire_nbytes(ref)


@pytest.mark.parametrize("n", [0, 1, 255, 257])
@pytest.mark.parametrize("block", [1, 128, 256])
@pytest.mark.parametrize("kind", KINDS)
def test_codec_bits_equal_the_reference(kind, block, n):
    _check(_inputs("normal", n, seed=n + block), kind, block)


@pytest.mark.parametrize("case", ["zeros", "mixed"])
@pytest.mark.parametrize("block", [1, 128, 256])
@pytest.mark.parametrize("kind", KINDS)
def test_codec_bits_on_zero_blocks_and_mixed_magnitudes(kind, block, case):
    _check(_inputs(case, 4099, seed=7), kind, block)


@pytest.mark.parametrize("kind", KINDS)
def test_fp8_edge_and_int8_ties(kind):
    """Values at the scale's edge (each block's absmax maps to 127 or 448
    exactly) and halves that round to even."""
    x = np.array([448.0, -448.0, 447.9, 1.0, 0.5, 1.5, 2.5, -0.5, 127.0, 63.5, -127.0,
                  3.0e-3, 1e-7], np.float32)
    for block in (1, 4, 13):
        _check(x, kind, block)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("device_path", [False, True], ids=["numpy", "tensor"])
def test_error_feedback_trajectory_equals_the_reference(kind, device_path):
    cfg = port_q.CollectiveConfig(quantize=kind, block_size=64)
    ref_cfg = ref_q.CollectiveConfig(quantize=kind, block_size=64)
    ref_ef, ef = ref_q.ErrorFeedback(), port_q.ErrorFeedback()
    rng = np.random.default_rng(11)
    for step in range(4):
        x = rng.standard_normal(1000).astype(np.float32) * (step + 1)
        ref = ref_ef.encode(("rs", "__ar", 0), x, ref_cfg)
        got = ef.encode(("rs", "__ar", 0), torch.from_numpy(x) if device_path else x, cfg)
        _same_encoding(ref, got)
        residual = ef.residual(("rs", "__ar", 0))
        residual = residual.numpy() if isinstance(residual, torch.Tensor) else residual
        assert np.array_equal(_bits(residual), _bits(ref_ef._residuals[("rs", "__ar", 0)]))
    assert ef.residual_norm() == pytest.approx(ref_ef.residual_norm(), rel=1e-6)
    # A new shape at the same site starts from a zero residual, as the reference's.
    y = rng.standard_normal(10).astype(np.float32)
    _same_encoding(ref_ef.encode(("rs", "__ar", 0), y, ref_cfg),
                   ef.encode(("rs", "__ar", 0), torch.from_numpy(y) if device_path else y, cfg))
    ef.reset()
    assert ef.residual_norm() == 0.0


def test_error_feedback_off_stores_nothing():
    cfg = port_q.CollectiveConfig(quantize="int8", error_feedback=False)
    ef = port_q.ErrorFeedback()
    ef.encode(("s",), np.ones(10, np.float32), cfg)
    ef.encode(("t",), torch.ones(10), cfg)
    assert ef.residual_norm() == 0.0


@pytest.mark.parametrize("kwargs", [
    {"quantize": "int4"}, {"quantize_activations": "bf16"}, {"block_size": 0},
    {"bucket_bytes": 0}, {"block_size": -3},
], ids=["quantize", "activations", "block_zero", "bucket_zero", "block_negative"])
def test_config_validation_errors_are_the_reference(kwargs):
    with pytest.raises(ValueError) as ref_err:
        ref_q.CollectiveConfig(**kwargs)
    with pytest.raises(ValueError) as port_err:
        port_q.CollectiveConfig(**kwargs)
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("kwargs", [
    {}, {"quantize": "int8"}, {"quantize": "fp8", "block_size": 64},
    {"quantize_activations": "int8", "error_feedback": False},
    {"overlap": True, "bucket_bytes": 1 << 20},
])
def test_config_fields_and_derived_configs_are_the_reference(kwargs):
    ref, port = ref_q.CollectiveConfig(**kwargs), port_q.CollectiveConfig(**kwargs)
    assert port_q.fp8_supported() and ref_q.fp8_supported()
    assert vars(port) == vars(ref)
    assert (port.enabled, port.wire_kind()) == (ref.enabled, ref.wire_kind())
    assert vars(port.activation_wire_config()) == vars(ref.activation_wire_config())
