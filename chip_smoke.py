#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printing one line and failing the script (non-zero exit, no
final line) if anything is wrong:

  1. device    the card's name and power limit (nvidia-smi)
  2. build     compiles ops/csrc/*.cu with nvcc into build/ray_tpu_torch/
  3. kernels   each hand-written kernel against its plain PyTorch version at
               the JAX test shapes and the serving shapes, with the kernel's,
               the plain version's and one library call's times and the
               card's least time for the same work (the bound)
  4. serve     TransformerConfig.llama2_7b() at full width and depth in bf16
               behind the @batch decorator (buckets 1, 4, 8) as
               release/serve_bert_http.py serves its encoder: 12 concurrent
               requests of 512 tokens, each checked against its own
               unbatched forward
  5. generate  4 prompts of 32 tokens through the KV cache token by token,
               checked against forward at the last prompt step, then 32
               greedy tokens
  6. launches  the kernels' launch counts over phases 4 and 5, which must
               match the layers the path ran

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

import asyncio
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch import _build
from ray_tpu_torch.models.transformer import (
    TransformerConfig, decode_step, forward, init_kv_cache, init_params,
)
from ray_tpu_torch.ops import flash_attention as flash_mod
from ray_tpu_torch.ops import rmsnorm as rmsnorm_mod
from ray_tpu_torch.serve.batching import batch

SEED = 0
# H100 SXM data-sheet peaks (dense): HBM bytes/s, and operations/s by type
# (bf16 on the tensor cores; f32 on the CUDA cores, as the kernels use it).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Kernel against plain version. Flash O is held by its absolute error, with
# the tolerances tests/test_ops.py holds the Pallas kernel to (the kernel
# rounds P to bf16 before P.V unnormalised, the plain version normalised,
# so bf16 O differs by more than rounding). RMSNorm's bf16 output is held
# in units in the last place of the plain result: both compute nearly equal
# f32 values and round once, so they may land one bf16 ulp apart and no
# more; a kernel that rounds an intermediate to bf16 lands further.
F32_TOL = 2e-5
BF16_TOL = 3e-2
RMSNORM_F32_TOL = 1e-5
RMSNORM_BF16_ULPS = 1.0
# LSE: f32 sums in another order; |LSE| ~ log(seq) + O(1).
LSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}
# bf16 logits of the 32-layer model (values of order 1): the batched and
# unbatched runs, and decode (f32 attention over the cache) against forward
# (flash, P in bf16), round at other places; different tokens differ by O(1).
LOGITS_TOL = 0.25
SERVE_SEQ = 512
SERVE_REQUESTS = 12
BUCKETS = [1, 4, 8]
GEN_BATCH, GEN_PROMPT, GEN_NEW, GEN_CACHE = 4, 32, 32, 128

_t_start = time.perf_counter()


def log(phase: str, **fields) -> None:
    print(f"[{time.perf_counter() - _t_start:7.1f}s] {phase}: {json.dumps(fields)}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call, from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(ops: float, nbytes: float, dtype) -> tuple[float, str]:
    """Least time (ms) the card could take: operations or bytes, the larger."""
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def bf16_ulps(out: torch.Tensor, plain: torch.Tensor) -> float:
    """max |out - plain| in bf16 units in the last place of plain: 2^(e-8)
    for |plain| in [2^(e-1), 2^e)."""
    ref = plain.float()
    _, exp = torch.frexp(ref.abs().clamp_min(2.0 ** -126))
    ulp = torch.pow(2.0, (exp - 8).float())
    return float(((out.float() - ref).abs() / ulp).max())


def device_time(fn) -> dict:
    """Device time of one call of fn, from torch.profiler's records of what
    ran on the card (kernels, copies): the total, and the five that took
    the most. The profiler slows the host, so the wall time to compare with
    comes from an unprofiled run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return {
        "device_ms": sum(r[1] for r in rows),
        "top": [{"op": k[:60], "ms": ms, "count": n} for k, ms, n in rows[:5]],
    }


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------- phase 1
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0])
    return smi


# ---------------------------------------------------------------- phase 2
def phase_build() -> None:
    start = time.perf_counter()
    _build.library()
    ptxas = [
        line.strip() for line in (_build.BUILD_DIR / "build.log").read_text().splitlines()
        if "registers" in line or "spill" in line
    ] if _build.build_seconds else []
    log("build", seconds=round(time.perf_counter() - start, 2),
        nvcc_seconds=_build.build_seconds, ptxas=ptxas)


# ---------------------------------------------------------------- phase 3
def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _causal_pairs(seq_q: int, seq_k: int, causal: bool) -> int:
    """(query, key) pairs the end-aligned causal mask leaves visible."""
    if not causal:
        return seq_q * seq_k
    offset = seq_k - seq_q
    return int(sum(min(max(i + offset + 1, 0), seq_k) for i in range(seq_q)))


# (name, batch, heads, seq_q, seq_k, head_dim, causal, dtype, tol): the JAX
# test shapes, ragged lengths no Pallas block divides, more queries than keys
# (rows that see no key), and every shape the main path gives the kernel:
# the serve buckets 1, 4 and 8 at 512 tokens, and generate's forward of 4
# prompts of 32 tokens. Times are taken at FLASH_TIMED.
FLASH_CHECKS = [
    ("s256_d64_causal", 2, 4, 256, 256, 64, True, torch.float32, F32_TOL),
    ("s256_d64_full", 2, 4, 256, 256, 64, False, torch.float32, F32_TOL),
    ("s128_d32", 1, 2, 128, 128, 32, True, torch.float32, F32_TOL),
    ("sq64_sk128", 1, 2, 64, 128, 32, True, torch.float32, F32_TOL),
    ("ragged_s100_d64", 1, 3, 100, 100, 64, True, torch.float32, F32_TOL),
    ("causal_sq130_sk70", 1, 2, 130, 70, 64, True, torch.float32, F32_TOL),
    ("ragged_sq37_sk200_bf16", 2, 2, 37, 200, 128, False, torch.bfloat16, BF16_TOL),
    ("gen_b4_h32_s32_d128_bf16", 4, 32, 32, 32, 128, True, torch.bfloat16, BF16_TOL),
    ("serve_b1_h32_s512_d128_bf16", 1, 32, 512, 512, 128, True, torch.bfloat16, BF16_TOL),
    ("serve_b4_h32_s512_d128_bf16", 4, 32, 512, 512, 128, True, torch.bfloat16, BF16_TOL),
    ("serve_b8_h32_s512_d128_bf16", 8, 32, 512, 512, 128, True, torch.bfloat16, BF16_TOL),
]
FLASH_TIMED = "serve_b8_h32_s512_d128_bf16"
# (name, x shape, dtype, offset, tol): any row count, an input whose data
# starts 4 bytes past an aligned address (the wrapper copies it to an
# aligned one), and every shape the main path gives the kernel: decode's
# [4, 1, 4096], generate's forward, and the serve buckets. f32 is held by
# its absolute error, bf16 in ulps. Times are taken at RMSNORM_TIMED.
RMSNORM_CHECKS = [
    ("rows512_d512_f32", (4 * 128, 512), torch.float32, 0, RMSNORM_F32_TOL),
    ("odd_rows7_d512_f32", (7, 512), torch.float32, 0, RMSNORM_F32_TOL),
    ("unaligned_rows7_d512_f32", (7, 512), torch.float32, 1, RMSNORM_F32_TOL),
    ("decode_b4_s1_d4096_bf16", (GEN_BATCH, 1, 4096), torch.bfloat16, 0, RMSNORM_BF16_ULPS),
    ("gen_b4_s32_d4096_bf16", (GEN_BATCH, GEN_PROMPT, 4096), torch.bfloat16, 0,
     RMSNORM_BF16_ULPS),
    ("serve_b1_s512_d4096_bf16", (1, SERVE_SEQ, 4096), torch.bfloat16, 0, RMSNORM_BF16_ULPS),
    ("serve_b4_s512_d4096_bf16", (4, SERVE_SEQ, 4096), torch.bfloat16, 0, RMSNORM_BF16_ULPS),
    ("serve_b8_s512_d4096_bf16", (8, SERVE_SEQ, 4096), torch.bfloat16, 0, RMSNORM_BF16_ULPS),
]
RMSNORM_TIMED = "serve_b8_s512_d4096_bf16"


def _flash_bound(b, h, sq, sk, d, causal, dtype) -> tuple[float, str]:
    ops = 4 * b * h * d * _causal_pairs(sq, sk, causal)  # QK^T and PV, 2 per multiply-add
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * h * sq * d + 2 * b * h * sk * d) * size + b * h * sq * 4  # q k v o, LSE
    return bound(ops, nbytes, dtype)


def _rmsnorm_bound(rows, dim, dtype) -> tuple[float, str]:
    ops = 4 * rows * dim  # square-add, and two multiplies per element (f32)
    size = torch.tensor([], dtype=dtype).element_size()
    return bound(ops, (2 * rows * dim + dim) * size, torch.float32)


def phase_kernels() -> list[dict]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    entries = []

    checks = []
    for name, b, h, sq, sk, d, causal, dtype, tol in FLASH_CHECKS:
        q = _randn(gen, (b, h, sq, d), dtype)
        k = _randn(gen, (b, h, sk, d), dtype)
        v = _randn(gen, (b, h, sk, d), dtype)
        out, lse = flash_mod._flash_forward(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = flash_mod.attention_reference(q, k, v, causal=causal)
        lse_ref = flash_mod._lse_reference(q, k, causal=causal, scale=d ** -0.5)
        err, lse_err = max_err(out, ref), max_err(lse, lse_ref)
        bound_ms, bound_by = _flash_bound(b, h, sq, sk, d, causal, dtype)
        checks.append(dict(
            shape=name, max_abs_err=err, tol=tol, lse_err=lse_err, lse_tol=LSE_TOL[dtype],
            kernel_ms=time_ms(lambda: flash_mod.flash_attention(q, k, v, causal=causal)),
            bound_ms=bound_ms,
        ))
        require(out.dtype == dtype and out.shape == q.shape, f"flash {name}: output shape/dtype")
        require(err < tol, f"flash {name}: max |O - plain| = {err} >= {tol}")
        require(lse_err < LSE_TOL[dtype], f"flash {name}: max |LSE - plain| = {lse_err}")
        if name == FLASH_TIMED:
            timed, inputs = checks[-1], (q, k, v)
    q, k, v = inputs
    bound_ms, bound_by = _flash_bound(*q.shape[:3], k.shape[2], q.shape[3], True, q.dtype)
    entries.append(dict(
        name="flash_attention_fwd", route="cuda",
        source="ray_tpu_torch/ops/csrc/flash_attention_fwd.cu",
        replaces="ray_tpu/ops/flash_attention.py:79",
        launches=None, max_abs_err=timed["max_abs_err"], err=timed["max_abs_err"], unit="abs",
        tol=timed["tol"], ms=timed["kernel_ms"],
        plain_ms=time_ms(lambda: flash_mod.attention_reference(q, k, v, causal=True)),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=time_ms(  # seq_q == seq_k here, where its top-left causal mask agrees
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
        ),
        library="torch.nn.functional.scaled_dot_product_attention",
        shape=FLASH_TIMED, checks=checks,
    ))
    _log_kernel(entries[-1])

    checks = []
    for name, shape, dtype, offset, tol in RMSNORM_CHECKS:
        rows, dim = int(np.prod(shape[:-1])), shape[-1]
        x = _randn(gen, (offset + rows * dim,), dtype)[offset:].view(shape)
        w = _randn(gen, (dim,), dtype)
        y = rmsnorm_mod.rmsnorm(x, w)
        torch.cuda.synchronize()
        plain = rmsnorm_mod.rmsnorm_reference(x, w)
        if dtype == torch.bfloat16:
            err, unit = bf16_ulps(y, plain), "bf16_ulps"
        else:
            err, unit = max_err(y, plain), "abs"
        checks.append(dict(
            shape=name, max_abs_err=max_err(y, plain), err=err, unit=unit, tol=tol,
            kernel_ms=time_ms(lambda: rmsnorm_mod.rmsnorm(x, w)),
            bound_ms=_rmsnorm_bound(rows, dim, dtype)[0],
        ))
        require(y.dtype == dtype and y.shape == x.shape, f"rmsnorm {name}: output shape/dtype")
        require(err <= tol, f"rmsnorm {name}: y vs plain {err} {unit} > {tol}")
        if name == RMSNORM_TIMED:
            timed, inputs = checks[-1], (x, w)
    x, w = inputs
    dim = x.shape[-1]
    bound_ms, bound_by = _rmsnorm_bound(x.numel() // dim, dim, x.dtype)
    entries.append(dict(
        name="rmsnorm", route="cuda", source="ray_tpu_torch/ops/csrc/rmsnorm.cu",
        replaces="ray_tpu/ops/rmsnorm.py:17",
        launches=None, max_abs_err=timed["max_abs_err"], err=timed["err"], unit=timed["unit"],
        tol=timed["tol"], ms=timed["kernel_ms"],
        plain_ms=time_ms(lambda: rmsnorm_mod.rmsnorm_reference(x, w)),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=(
            time_ms(lambda: F.rms_norm(x, (dim,), w, eps=1e-6)) if hasattr(F, "rms_norm") else None
        ),
        library="torch.nn.functional.rms_norm",
        shape=RMSNORM_TIMED, checks=checks,
    ))
    _log_kernel(entries[-1])
    return entries


def _log_kernel(e: dict) -> None:
    log("kernels", name=e["name"], max_err=e["max_abs_err"], err=e["err"], unit=e["unit"],
        tol=e["tol"],
        kernel_ms=e["ms"], plain_ms=e["plain_ms"], library_ms=e["library_ms"],
        bound_ms=e["bound_ms"], bound_by=e["bound_by"], checks=e["checks"])


# ---------------------------------------------------------------- phase 4
class Llama2Encoder:
    """The serving deployment, shaped as release/serve_bert_http.py's
    BertEncoder: bucketed dynamic batching in front of forward."""

    def __init__(self, params: dict, config: TransformerConfig, seq: int):
        self.params, self.config, self.seq = params, config, seq
        self.forwards = 0
        # Warm every batching bucket once, as the JAX deployment compiles them.
        for bucket in BUCKETS:
            self._run(np.zeros((bucket, seq), np.int64))
        torch.cuda.synchronize()

    def _run(self, tokens: np.ndarray) -> torch.Tensor:
        with torch.inference_mode():
            logits = forward(self.params, torch.from_numpy(tokens).cuda(), self.config)
        self.forwards += 1
        return logits

    @batch(max_batch_size=8, batch_wait_timeout_s=0.005, bucket_sizes=BUCKETS)
    async def __call__(self, bodies: list) -> list:
        tokens = np.zeros((len(bodies), self.seq), np.int64)
        for i, body in enumerate(bodies):
            ids = body["token_ids"][: self.seq]
            tokens[i, : len(ids)] = ids
        last = self._run(tokens)[:, -1].cpu()
        return [{"logits": row, "next_token": int(row.argmax())} for row in last]


def phase_serve(params: dict, config: TransformerConfig) -> dict:
    rng = np.random.default_rng(SEED + 1)
    start = time.perf_counter()
    encoder = Llama2Encoder(params, config, SERVE_SEQ)
    warm_s = time.perf_counter() - start
    requests = [
        {"token_ids": rng.integers(0, config.vocab_size, SERVE_SEQ).tolist()}
        for _ in range(SERVE_REQUESTS)
    ]

    async def fire():
        return await asyncio.gather(*(encoder(body) for body in requests))

    start = time.perf_counter()
    answers = asyncio.run(fire())
    elapsed = time.perf_counter() - start
    batched_forwards = encoder.forwards - len(BUCKETS)

    errs = []
    for body, answer in zip(requests, answers):
        logits = answer["logits"]
        require(logits.shape == (config.vocab_size,), "serve: answer shape")
        require(bool(torch.isfinite(logits).all()), "serve: non-finite logits")
        alone = encoder._run(np.asarray([body["token_ids"]], np.int64))[0, -1].cpu()
        errs.append(max_err(logits, alone))
    # One full-bucket forward, timed alone and then profiled.
    tokens8 = np.asarray([body["token_ids"] for body in requests[:8]], np.int64)
    torch.cuda.synchronize()
    start = time.perf_counter()
    encoder._run(tokens8)
    torch.cuda.synchronize()
    forward8_ms = (time.perf_counter() - start) * 1e3
    prof = device_time(lambda: encoder._run(tokens8))
    # What a wrong answer would look like: two different requests' logits.
    other = max_err(answers[0]["logits"], answers[1]["logits"])
    require(max(errs) < LOGITS_TOL, f"serve: batched vs unbatched {max(errs)} >= {LOGITS_TOL}")
    result = dict(
        requests=len(answers), seq=SERVE_SEQ, batches=batched_forwards,
        seconds=elapsed, requests_per_s=len(answers) / elapsed,
        prefill_tokens_per_s=len(answers) * SERVE_SEQ / elapsed,
        warmup_seconds=warm_s, max_err_vs_unbatched=max(errs), tol=LOGITS_TOL,
        different_request_diff=other,
        logit_abs_max=float(max(a["logits"].abs().max() for a in answers)),
        forward_b8_ms=forward8_ms, forward_b8_device_ms=prof["device_ms"],
        forward_b8_device_idle_share=1.0 - prof["device_ms"] / forward8_ms,
        forward_b8_top=prof["top"], forwards=encoder.forwards,
    )
    log("serve", **result)
    return result


# ---------------------------------------------------------------- phase 5
def phase_generate(params: dict, config: TransformerConfig) -> dict:
    rng = np.random.default_rng(SEED + 2)
    prompts = torch.from_numpy(
        rng.integers(0, config.vocab_size, (GEN_BATCH, GEN_PROMPT))
    ).cuda()
    with torch.inference_mode():
        cache = init_kv_cache(config, GEN_BATCH, GEN_CACHE, device="cuda")
        torch.cuda.synchronize()
        start = time.perf_counter()
        for i in range(GEN_PROMPT):
            logits, cache = decode_step(params, cache, prompts[:, i : i + 1], config)
        torch.cuda.synchronize()
        prompt_s = time.perf_counter() - start
        full = forward(params, prompts, config)[:, -1]
        err = max_err(logits, full)
        require(err < LOGITS_TOL, f"generate: decode vs forward {err} >= {LOGITS_TOL}")
        token = logits.argmax(-1, keepdim=True)
        generated = [token]
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(GEN_NEW - 1):
            logits, cache = decode_step(params, cache, token, config)
            token = logits.argmax(-1, keepdim=True)
            generated.append(token)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - start
        prof = device_time(lambda: decode_step(params, cache, token, config))
    out = torch.cat(generated, dim=1).cpu()
    require(bool(torch.isfinite(logits).all()), "generate: non-finite logits")
    require(out.shape == (GEN_BATCH, GEN_NEW), "generate: token shape")
    require(bool(((out >= 0) & (out < config.vocab_size)).all()), "generate: token range")
    require(int(cache["length"]) == GEN_PROMPT + GEN_NEW - 1, "generate: cache length")
    steps = GEN_PROMPT + GEN_NEW
    step_ms = 1e3 * decode_s / (GEN_NEW - 1)
    result = dict(
        batch=GEN_BATCH, prompt=GEN_PROMPT, new_tokens=GEN_NEW, cache=GEN_CACHE,
        max_err_decode_vs_forward=err, tol=LOGITS_TOL,
        prompt_decode_tokens_per_s=GEN_BATCH * GEN_PROMPT / prompt_s,
        decode_tokens_per_s=GEN_BATCH * (GEN_NEW - 1) / decode_s,
        decode_step_ms=step_ms, decode_step_device_ms=prof["device_ms"],
        decode_device_idle_share=1.0 - prof["device_ms"] / step_ms,
        decode_step_top=prof["top"], decode_steps=steps, forwards=1, first_tokens=out[0, :8].tolist(),
    )
    log("generate", **result)
    return result


# ---------------------------------------------------------------- main
def main() -> None:
    phase_device()
    phase_build()
    entries = phase_kernels()

    start = time.perf_counter()
    config = TransformerConfig.llama2_7b()
    params = init_params(config, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log("params", config="llama2_7b", layers=config.n_layers, dim=config.dim,
        dtype=str(config.dtype), seconds=time.perf_counter() - start,
        gib=torch.cuda.memory_allocated() / 2**30)

    # The main path runs from here: every count starts at 0.
    flash_mod.flash_attention.launches = 0
    rmsnorm_mod.rmsnorm.launches = 0
    torch.cuda.reset_peak_memory_stats()
    serve = phase_serve(params, config)
    gen = phase_generate(params, config)
    flash_launches = flash_mod.flash_attention.launches
    rmsnorm_launches = rmsnorm_mod.rmsnorm.launches

    forwards = serve["forwards"] + gen["forwards"]
    layers = config.n_layers
    want_flash = layers * forwards
    want_rmsnorm = (2 * layers + 1) * (forwards + gen["decode_steps"])
    log("launches", flash_attention=flash_launches, rmsnorm=rmsnorm_launches,
        forwards=forwards, decode_steps=gen["decode_steps"],
        expected_flash=want_flash, expected_rmsnorm=want_rmsnorm,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    require(flash_launches == want_flash, "flash kernel launches do not match the path")
    require(rmsnorm_launches == want_rmsnorm, "rmsnorm kernel launches do not match the path")
    entries[0]["launches"] = flash_launches
    entries[1]["launches"] = rmsnorm_launches
    for e in entries:  # the same numbers under the names the phase-3 lines use
        e["max_err"], e["kernel_ms"] = e["max_abs_err"], e["ms"]

    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
