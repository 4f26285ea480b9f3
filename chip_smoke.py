"""Drive the PyTorch / CUDA port on one GPU, end to end.

Run from the root of a checkout on a machine with a CUDA card:

    python chip_smoke.py

Phases (each prints one line; any failed check raises, so the script exits
non-zero and never prints the last line):

(a) build the kernels of ``nylon_amt_tpu_torch/csrc`` with nvcc (sm_90a);
(b) K1, the log-mel kernel, within atol 2e-4 of a float64 truth on 120 s of
    seeded audio and on a quiet variant of it (see the check), and the
    kernel's and the plain version's times;
(c) K2, K3, K4 and K5 against their plain versions at the shapes of a
    batch-32 paper-scale bf16 forward (K2 on random and on the real
    windows): the bf16 gate against the plain f32 truth, at most 4 bf16 ulps
    from the plain bf16 version, and both times;
(d) the whole slice through the CLI: a seeded paper-scale bf16 model saved
    as a reference ``.dat``, a 120 s synthetic WAV, ``transcribe --device
    cuda``, and the MIDI file read back;
(e) on one batch of 32 windows, ``engine.forward`` against the plain
    ``HFT.forward`` per output key (the bf16 gate, and at most 8 / 64 bf16
    ulps from the plain bf16 forward for the stage-1 / stage-2 heads), the
    ms per forward and the device time per kernel;
(f) the launch counts of run (d): every kernel of the path ran;
(g) K6, the dropout-mask kernel, bit for bit equal to its plain version on
    every site shape of the batch-8 train step (packed and unpacked, f32
    and bf16);
(h) K7, K8 and K9 (the training layers) at the batch-8 paper bf16 shapes,
    dropout 0.1 (and the embedding site for K7): the forward within 4 bf16
    ulps of the plain bf16 twin and the bf16 gate against the plain f32
    truth, at rate 0 equal to the inference kernels of (c); the backward's
    input gradients under the bf16 gate (also scaled by the truth's largest
    value) and within 12 bf16 ulps of the plain bf16 twin; the same
    backward with its stage hook, every kernel fed the plain twin's own
    inputs: each output within 4 bf16 ulps of the twin's same stage, each
    weight gradient within 1e-4 of the twin's; each weight gradient of the
    plain run within 2e-2 of the plain bf16 one's largest value and under
    the gate, bit-identical from run to run; both times;
(i) training through the CLI: a paper bf16 config (dropout 0.1, batch 8)
    and seeded train and valid splits, ``train --epochs 1 --device cuda``,
    finite losses, the launch counts per step, then ``transcribe`` of (d)'s
    WAV with the trained checkpoint;
(j) the batch-8 train step's time by CUDA events and a per-kernel profile;
(k) K13, the int8 (W8A8) layers: the row and column quantizers bit for bit
    equal to their plain versions; each of the four wrappers at the
    batch-32 shapes (the stem's on the real windows) with >= 99.9% of the
    elements within 4 bf16 ulps of its plain q8 version and every element
    within 0.08 of it, and no further from the exact bf16 layer than the
    plain q8 version + 4 ulps; the int8 forward's
    posteriors within 0.06 of the bf16 forward's; ``transcribe --int8
    --list --tab --sheet --save-posteriors --device cuda`` on (d)'s WAV and
    ``evaluate`` of its notes and posteriors, with the launch counts (every
    K13 wrapper, no bf16 K2-K5); the kernels', plain versions', bf16
    kernels' and ``torch._int_mm`` times, both forwards' times and a
    profile of the int8 forward;
(l) K10, K11 and K12 (the per-site attention of ``csrc/mha.cu``) forward and
    backward at every attention shape of the paper model, batch 8 and 32:
    outputs within 4 bf16 ulps of the plain bf16 version and under the
    bf16 gate, input gradients within 12 ulps and under the gate (also
    scaled by max |truth|), bit-identical backward runs; K11's output equal
    to K10's, its probabilities within 1e-5 of the plain f32 ones and its
    rows summing to 1 +- 1e-5; K12's realized masks bit for bit the plain
    ones; times beside SDPA's. A batch-32 ``return_attention`` forward
    through the per-site path (10 K10 + 1 K11 launches, no K2-K5) within
    8 / 64 ulps of the engine's forward on the same weights, with its
    time and profile. Through the CLI, ``train --epochs 1`` then
    ``transcribe`` with the checkpoint for ``--remat`` (dropout 0.1: K12
    forward twice per site and step, backward once, no K7-K9), a
    ``return_attention`` config at dropout 0 (K10's and K11's backward),
    1FLT and 2FDT (BatchNorm statistics move): every launch count, finite
    losses. The per-site train steps' times and profiles beside (j)'s.
    Each (l) time prints beside SDPA's and, where ``PERF.md`` has one, the
    time of the ``wmma`` kernels that ``csrc/mha.cu`` replaced;
(m) the default ``ModelConfig()`` in bf16 (hid 64 over 2 heads: head_dim
    32): K10-K12's D = 32 kernels at the four site geometries, batch 8 and
    32, under (l)'s gates; the batch-32 engine forward against the plain
    bf16 forward under (e)'s gates, with its launch counts, time and
    profile; ``cli train`` (3 steps of 16 through the fused training
    layers, no per-site kernel), ``cli transcribe --list`` with its
    checkpoint and ``cli evaluate``, with their launch counts.

(n) the default ``Config()`` in float32 (hid 64 over 2 heads: head_dim 32;
    the f32 kernels of ``csrc/layer_fused_f32.cu``, ``csrc/mha_f32.cu`` and
    the f32 instantiations of the stem, LayerNorm-backward and int8
    kernels): (n.1) K10-K12 at D = 32 and 64 at the four site geometries,
    batch 8: outputs within 2e-5 of max(1, max |plain f32|), input
    gradients within 1e-4 of max |plain|, K11's probabilities within 1e-6
    and its output K10's bit for bit, K12's realized masks bit for bit,
    bit-identical backward runs; the blocks per SM of the kernels; times
    beside the earlier all-FFMA kernels' (FFMA_F32_MS), f32 SDPA, and three
    bounds: the products as they run (forward: FFMA scores, 3xTF32 PV;
    backward: 3xTF32), all as 3xTF32, all on FFMA; (n.2) K2-K5 at
    batch 32 and K7-K9 forward and backward at batch 8, at the default and
    the paper widths, under the same limits (ReLU gate flips aside), with
    (h)'s stage hook (every backward kernel on the twin's inputs within
    1e-5 of the twin's stage); times beside f32 ``torch.matmul`` of the
    layer's GEMMs; (n.3) K13 at head_dim 32 in bf16 and f32 (quantizers
    bit for bit, (k)'s gates, and in f32 each kernel on the plain
    version's own codes), and K13 in f32 at the paper widths (head_dim 64)
    under the same gates; (n.4) the engine's
    batch-32 f32 forward of ``Config()`` and ``paper_scale()`` against the
    plain f32 forward (A heads within 2e-5, B heads within 2e-4 of max(1,
    max |plain|)), the default int8 forward under (k)'s posterior gates,
    the default f32 train step; (n.5) ``cli train`` (3 steps) ->
    ``transcribe --list`` -> ``evaluate``, then ``transcribe --int8`` and
    ``evaluate``, all with no ``--config``, with their launch counts.

Every profile ((e), (j), (k), (l), (m), (n)) also prints the device time
and share of the attention kernels of ``csrc/mha.cu`` and
``csrc/mha_f32.cu``.

PyTorch's global TF32 flags stay at their defaults: the port's own guards
keep its f32 paths at f32 accuracy (IEEE f32; the f32 attention's PV
product and its backward's products as 3xTF32), and the script wraps only
its own f32 references in ``full_f32``.

Before the last line it prints the card's name and power limit and one JSON
object with, per wrapper, the dtypes and head dims this run held against
its plain version (``held``), its float32 sources and (n)'s f32 times
(``f32``), and its launches (K1-K5 from (d), K6-K9 from (i), K13
from (k), K12 from (l)'s ``--remat`` training, K10 and K11 from its
``return_attention`` training), error, times and bound (the larger of the
bytes it must move over 3.35 TB/s and its operations over 989 TFLOP/s bf16,
1,979 TOP/s int8 for K13's products, 494.7 / 3 TFLOP/s for the f32
attention's 3xTF32 products (PV, and every backward product), 67 TFLOP/s
for K1's and the stem's f32 and f64 work, the f32 attention's scores and
K12's mask hashes: the H100 SXM's published rates).
The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SR = 16000
AUDIO_SEC = 120.0
SEED = 0
BATCH = 32
K1_ATOL = 2e-4     # log-mel, from the float64 truth
ULPS = 4           # kernel vs plain bf16: ulps of the output's largest value
# engine vs plain bf16 forward, per head family: stage 2 (the B heads) runs
# on stage 1's output through three more layers, and amplifies every
# difference as it amplifies the plain bf16 forward's own rounding (see (e))
ULPS_FORWARD = {"A": 8, "B": 64}
TRAIN_BATCH = 8    # windows per train step, bench.py's
DROP_SEED = 987654  # dropout seed of (h)
RATE = 0.1          # dropout rate of the paper recipe
WGRAD_REL = 2e-2   # weight grad vs plain bf16, of max |plain bf16|
# backward input grads vs the plain bf16 twin, chained through the ~10 bf16
# roundings of the backward: read at 7.0-10.25 ulps on an H100 (each kernel
# is <= 1 ulp from the twin on the twin's inputs); the plain bf16 twin itself
# reads 16.45 ulps from the f32 truth. At the default widths (hid 64, (m))
# the same chain reads up to 12.56 ulps while every kernel is still <= 1 ulp
# from the twin on the twin's inputs and the twin reads 22-30 ulps from the
# truth, so (m) bounds the chain by the twin's own distance from the truth
CHAIN_ULPS = 12
# weight grads of the backward kernels on the plain twin's own inputs: the
# same bf16 operands summed in f32 in another order
STAGE_WGRAD_REL = 1e-4
# the kernels' outputs that the stage hook sees, per layer kind
STAGES = {"enc": 16, "dec_zero": 18, "dec": 27}
# K13 against its plain q8 version: the int8 sums are exact on both sides,
# so only a code flipped at a rounding boundary (another f32 order in LN or
# l, or another exp2) moves an element past 4 ulps
Q8_SHARE = 0.999
# and every element within 0.08 of the plain q8 version
# (tests/test_engine_q8.py's budget). Against the exact bf16 layer the
# kernel may be no further than the plain q8 version is + 4 ulps: that
# distance is the W8A8 scheme's, not the kernel's (the plain q8 version
# itself reads 0.094 on the decoder layer over 268 M elements, and 2.3-4.6
# on the stem layer, whose exact bf16 layer is ill-conditioned on random
# weights: PERF.md)
Q8_BUDGET = 0.08
# int8 forward vs bf16 forward, posteriors: the stage-1 (A) heads within
# 0.06 (tests/test_engine_q8.py's budget); every head within 1.5 x the plain
# q8 forward's own distance from the bf16 forward (stage 2 amplifies the
# scheme's error: 0.10-0.14 in the B heads on random paper weights, and a
# code flipped at a rounding boundary moves every later layer's codes, so
# two int8 forwards are as far apart as int8 is from bf16)
Q8_POST = 0.06
Q8_FORWARD_REL = 1.5
HBM_BPS = 3.35e12   # H100 SXM device memory, bytes/s
BF16_FLOPS = 989e12  # dense bf16 tensor cores
INT8_OPS = 1979e12   # dense int8 tensor cores
F32_FLOPS = 67e12    # f32 (and K1's f64 work) outside the tensor cores
TF32_FLOPS = 494.7e12  # dense TF32 tensor cores: 3xTF32 takes three a product


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 5, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bf16_gate(name: str, got, plain16, truth) -> tuple[float, float]:
    """The scale-invariant bf16 gate: the kernel's error from the f32 truth
    must stay within twice the plain bf16 version's own error + 1e-3."""
    t = truth.float()
    scale = t.abs().clamp_min(1.0)
    e_kernel = ((got.float() - t).abs() / scale).max().item()
    e_plain = ((plain16.float() - t).abs() / scale).max().item()
    if not (math.isfinite(e_kernel) and e_kernel <= 2.0 * e_plain + 1e-3):
        raise AssertionError(f"{name}: kernel bf16 err {e_kernel:.5f} vs "
                             f"plain bf16 err {e_plain:.5f}")
    return e_kernel, e_plain


def bf16_ulp(x) -> float:
    """The spacing of bf16 values at the largest magnitude in ``x``."""
    top = x.float().abs().max().item()
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 2.0 ** -133


def ulp_distance(got, plain16) -> tuple[float, float]:
    """(max |got - plain16|, that distance in bf16 ulps of max |plain16|)."""
    d = (got.float() - plain16.float()).abs().max().item()
    return d, d / bf16_ulp(plain16)


def synth_audio(seconds: float, rng: np.random.Generator,
                noise: float = 0.05) -> np.ndarray:
    """Decaying sines at a few MIDI pitches, a new note every 0.25 s, over a
    noise floor."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    wav = noise * rng.standard_normal(n)
    pitches = (48, 55, 60, 64, 67, 72, 76)
    for i, start in enumerate(np.arange(0.0, seconds - 1.0, 0.25)):
        f = 440.0 * 2 ** ((pitches[i % len(pitches)] - 69) / 12)
        s = int(start * SR)
        tt = t[s:s + SR] - start
        wav[s:s + SR] += 0.2 * np.exp(-3.0 * tt) * np.sin(2 * np.pi * f * tt)
    return wav.astype(np.float32)


def profile_forward(fwd, iters: int = 10, phase: str = "e",
                    what: str = "forward", top: int = 12) -> None:
    """Device time per kernel over ``iters`` calls of ``fwd`` (forwards,
    or train steps), by torch.profiler, and the device-busy share of the
    profiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    grad = torch.no_grad() if what == "forward" else contextlib.nullcontext()
    with grad, profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fwd()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    rows = sorted(((e.key, e.self_device_time_total / 1e3 / iters,
                    e.count // iters) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"({phase}) profile, {iters} {what}s: {wall:.3f} ms wall per "
        f"{what}, {busy:.3f} ms device-busy ({busy / wall:.1%})")
    for name, ms, calls in rows[:top]:
        log(f"({phase})   {name[:64]:<64} {ms:8.3f} ms {ms / busy:6.1%} "
            f"x{calls}")
    attn = [(name, ms, calls) for name, ms, calls in rows
            if "attn_fwd_" in name or "attn_bwd_" in name]
    if attn:
        ms = sum(r[1] for r in attn)
        log(f"({phase})   attention kernels of csrc/mha.cu and "
            f"csrc/mha_f32.cu: {ms:.3f} ms, "
            f"{ms / busy:.1%} of device-busy, "
            f"{sum(r[2] for r in attn)} launches per {what}: "
            + "; ".join(f"{name.split('namespace)::', 1)[-1][:44]} "
                        f"{ms_:.3f} ms {ms_ / busy:.1%} x{c}"
                        for name, ms_, c in attn))


def bound(nbytes: float, flops: float = 0.0, f32_flops: float = 0.0,
          int8_ops: float = 0.0, tf32x3_flops: float = 0.0) -> dict:
    """The least time the card could take: bytes over the memory rate, or
    operations over the peak rate of their type, whichever is larger
    (``tf32x3_flops``: f32 products taken as three TF32 products each)."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = (flops / BF16_FLOPS + f32_flops / F32_FLOPS
             + int8_ops / INT8_OPS + tf32x3_flops / (TF32_FLOPS / 3)) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


HELD: dict[str, set] = {}


def held(name: str, dt, d: int | None = None) -> None:
    """Record that this run held wrapper ``name`` against its plain version
    in dtype ``dt`` at head_dim ``d`` (the ``held`` field of its JSON
    row)."""
    label = {torch.bfloat16: "bf16", torch.float32: "f32"}[dt]
    HELD.setdefault(name.split("/")[0], set()).add(
        label if d is None else f"{label}/D{d}")


def bwd_name(name: str) -> str:
    """The backward's row name of a layer check ``name`` ("x/time" ->
    "x_bwd/time")."""
    base, sep, rest = name.partition("/")
    return f"{base}_bwd{sep}{rest}"


def rel_err(got, want, floor: float = 0.0) -> float:
    """max |got - want| over max(floor, max |want|)."""
    top = max(floor, want.float().abs().max().item())
    return (got.float() - want.float()).abs().max().item() / top


def layer_flops(kind: str, n: int, lq: int, lk: int, hid: int,
                pf: int) -> int:
    """Matrix-product FLOPs of one layer forward (enc, dec_zero, dec)."""
    mq, mk = n * lq, n * lk
    f = 2 * mq * hid * hid + 2 * 2 * mq * hid * pf          # O, FFN
    if kind == "enc":
        return f + 2 * mq * hid * 3 * hid + 4 * n * lq * lq * hid
    f += 2 * mq * hid * hid + 2 * mk * hid * 2 * hid + 4 * n * lq * lk * hid
    if kind == "dec":
        f += 2 * mq * hid * 3 * hid + 2 * mq * hid * hid + 4 * n * lq * lq * hid
    return f


def attn_product_flops(kind: str, n: int, lq: int, lk: int, hid: int) -> int:
    """FLOPs of one of the two products (scores, PV) of a layer's attention
    steps (enc: self; dec_zero: cross; dec: self and cross): half of the
    attention's share of ``layer_flops``."""
    f = 2 * n * lq * (lq if kind == "enc" else lk) * hid
    return f + (2 * n * lq * lq * hid if kind == "dec" else 0)


def sdpa_ms(n: int, lq: int, lk: int, heads: int, dev, backward: bool,
            d: int = 64) -> float:
    """Time of torch's scaled_dot_product_attention at one attention shape
    with heads of ``d`` (the library yardstick of a layer's attention
    piece; the port never calls it)."""
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(1)

    def r(L):
        return torch.randn((n, heads, L, d), generator=g, device=dev,
                           dtype=torch.bfloat16, requires_grad=backward)

    q, k, v = r(lq), r(lk), r(lk)
    do = torch.randn((n, heads, lq, d), generator=g, device=dev,
                     dtype=torch.bfloat16)

    def run():
        o = F.scaled_dot_product_attention(q, k, v)
        if backward:
            torch.autograd.grad(o, (q, k, v), do)

    return cuda_ms(run, iters=5)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check_masks(dev) -> dict:
    """(g): the K6 kernel's masks against the plain version, bit for bit,
    on every dropout site shape of the batch-8 paper train step."""
    from nylon_amt_tpu_torch.ops import attention as att

    n_f, n_t = TRAIN_BATCH * 128, TRAIN_BATCH * 88
    sites = [  # shape, dtype: activations bf16, probabilities f32
        ((n_f, 256, 256), torch.bfloat16), ((n_f, 256, 512), torch.bfloat16),
        ((n_f, 256, 256), torch.float32),
        ((n_t, 128, 256), torch.bfloat16), ((n_t, 128, 512), torch.bfloat16),
        ((n_t, 128, 128), torch.float32),
        ((n_f, 88, 256), torch.bfloat16), ((n_f, 88, 512), torch.bfloat16),
        ((n_f, 88, 256), torch.float32), ((n_f, 88, 88), torch.float32)]
    for i, (shape, dt) in enumerate(sites):
        got = att.hash_keep_mask(DROP_SEED, 3 + i, 0, shape, RATE, dt, dev)
        want = att.hash_keep_mask_plain(DROP_SEED, 3 + i, 0, shape, RATE, dt,
                                        dev)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K6 mask {shape} {dt}: "
                                 f"{(got != want).sum().item()} elements "
                                 f"differ from the plain version")
        held("hash_keep_mask", dt)
        log(f"(g) K6 mask {shape} {str(dt)[6:]} "
            f"({'packed' if shape[2] % 256 == 0 else 'unpacked'}): equal to "
            f"the plain version, keep share {(got != 0).float().mean():.5f}")
    # the main path's launch: x * mask on the first frequency layer's input
    x = torch.randn((n_f, 256, 256), device=dev).to(torch.bfloat16)
    ms = cuda_ms(lambda: att.apply_keep_mask(x, DROP_SEED, 6, RATE), iters=10)
    plain_ms = cuda_ms(lambda: x * att.hash_keep_mask_plain(
        DROP_SEED, 6, 0, tuple(x.shape), RATE, x.dtype, dev), iters=3)
    ops = 8 * x.numel()  # hash + select per element, packed (two per hash)
    res = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
               **bound(2 * nbytes(x), f32_flops=ops), library_ms=None,
               gate="bit-identical masks on every site shape")
    log(f"(g) K6 x * mask at {tuple(x.shape)} bf16: kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, bound {res['bound_ms']:.3f} ms "
        f"({res['bound_by']})")
    return res


def _train_layers(model, dev, dtype=torch.bfloat16) -> dict:
    """The training layers of (h) with ``model``'s weights and seeded
    activations in ``dtype`` at the batch-8 shapes: name -> (kind, inputs,
    f32 params, emb_drop)."""
    from nylon_amt_tpu_torch.models import fused_train as ft

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    hid = model.config.model.hid_dim

    def act(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def det(p):
        return type(p)(*(t.detach().contiguous() for t in p))

    enc, dec = model.encoder_spec2midi, model.decoder_spec2midi
    n_f, n_t = TRAIN_BATCH * 128, TRAIN_BATCH * 88
    return {
        "encoder_layer_train": ("enc", (act(n_f, 256, hid),),
                                det(ft._pack_enc(enc.layers_freq[0])), True),
        "encoder_layer_train/time": ("enc", (act(n_t, 128, hid),),
                                     det(ft._pack_enc(dec.layers_time[0])),
                                     True),
        "decoder_layer_zero_train": (
            "dec_zero", (act(n_f, 88, hid), act(n_f, 256, hid)),
            det(ft._pack_dec(dec.layer_zero_freq, False)), False),
        "decoder_layer_train": (
            "dec", (act(n_f, 88, hid), act(n_f, 256, hid)),
            det(ft._pack_dec(dec.layers_freq[0], True)), False)}


def _layer_fns(kind: str, emb: bool, heads: int):
    """(kernel fwd, plain fwd, kernel bwd, plain bwd) of a layer kind, as
    functions of (inputs, params, rate[, dz[, stage hook | taps dict]])."""
    from nylon_amt_tpu_torch.ops import layer_fused_train as lt

    if kind == "enc":
        return (lambda xs, p, r: lt.encoder_layer_train_cuda(
                    xs[0], p, DROP_SEED, heads, r, emb),
                lambda xs, p, r: lt.encoder_layer_train_plain(
                    xs[0], p, DROP_SEED, heads, r, emb),
                lambda xs, p, r, dz, tap=None: lt.encoder_layer_train_bwd_cuda(
                    xs[0], p, DROP_SEED, dz, heads, r, emb, tap=tap),
                lambda xs, p, r, dz, taps=None: lt.encoder_layer_train_bwd_plain(
                    xs[0], p, DROP_SEED, dz, heads, r, emb, taps))
    fwd_plain = (lt.decoder_layer_train_plain if kind == "dec"
                 else lt.decoder_layer_zero_train_plain)
    bwd_plain = (lt.decoder_layer_train_bwd_plain if kind == "dec"
                 else lt.decoder_layer_zero_train_bwd_plain)
    return (lambda xs, p, r: lt.decoder_layer_train_cuda(
                *xs, p, DROP_SEED, heads, r),
            lambda xs, p, r: fwd_plain(*xs, p, DROP_SEED, heads, r),
            lambda xs, p, r, dz, tap=None: lt.decoder_layer_train_bwd_cuda(
                *xs, p, DROP_SEED, dz, heads, r, tap=tap),
            lambda xs, p, r, dz, taps=None: bwd_plain(
                *xs, p, DROP_SEED, dz, heads, r, taps))


def _split_bwd(kind, out):
    """(input gradients, weight-gradient params) of a backward result."""
    return (list(out[:1]), out[1]) if kind == "enc" else (list(out[:2]),
                                                          out[2])


def check_train_layers(model, cfg, dev, k3k5, phase: str = "h",
                       chain_ulps: float | None = CHAIN_ULPS) -> dict:
    """(h): K7, K8, K9 forward and backward against their plain twins, at
    the batch-8 shapes of ``model``'s config. ``chain_ulps`` bounds the
    chained input grads' distance from the plain bf16 twin; None bounds it
    by the twin's own distance from the f32 truth on the same gradient."""
    from nylon_amt_tpu_torch.ops import layer_fused as lf
    from nylon_amt_tpu_torch.ops.precision import full_f32

    m = cfg.model
    hid, pf = m.hid_dim, m.pf_dim
    results = {}
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    for name, (kind, xs, p, emb) in _train_layers(model, dev).items():
        heads = m.enc_head if kind == "enc" else m.dec_head
        k_fwd, p_fwd, k_bwd, p_bwd = _layer_fns(kind, emb, heads)
        n, lq, _ = xs[0].shape
        lk = xs[-1].shape[1]
        xs32 = [x.float() for x in xs]
        # forward at rate 0: the inference kernels of (c), bit for bit
        p16 = lf.CrossLayerParams(**{
            f: getattr(p, f) if hasattr(p, f) else torch.zeros(0, device=dev)
            for f in lf.CrossLayerParams._fields}) if kind != "enc" else p
        packed = type(p16)(*(t.float().contiguous() if f in ("g", "b") else
                             t.to(torch.bfloat16).contiguous()
                             for f, t in zip(p16._fields, p16)))
        zero = k_fwd(xs, p, 0.0)
        inf = k3k5[kind](*xs, packed, heads)
        zero_ulps = ulp_distance(zero, inf)[1]
        if not zero_ulps <= 1.0:
            raise AssertionError(f"{name}: rate 0 is {zero_ulps:.2f} ulps "
                                 f"from the inference kernels")
        # forward with dropout
        got = k_fwd(xs, p, RATE)
        plain16 = p_fwd(xs, p, RATE)
        with full_f32():
            truth = p_fwd(xs32, p, RATE)
        torch.cuda.synchronize()
        fe_k, fe_p = bf16_gate(f"{name} fwd", got, plain16, truth)
        err, ulps = ulp_distance(got, plain16)
        if not ulps <= ULPS:
            raise AssertionError(f"{name} fwd: {ulps:.2f} ulps from plain "
                                 f"bf16 > {ULPS}")
        del truth
        # backward
        dz = torch.randn(xs[0].shape, generator=g, device=dev).to(
            torch.bfloat16)
        kb = k_bwd(xs, p, RATE, dz)
        kb2 = k_bwd(xs, p, RATE, dz)
        k_in, k_w = _split_bwd(kind, kb)
        k_in2, k_w2 = _split_bwd(kind, kb2)
        if not all(torch.equal(a, b) for a, b in zip(list(k_w) + k_in,
                                                     list(k_w2) + k_in2)):
            raise AssertionError(f"{name} bwd: two runs differ")
        del kb2, k_in2, k_w2
        taps = {}
        p_in, p_w = _split_bwd(kind, p_bwd(xs, p, RATE, dz, taps))
        with full_f32():
            t_in, t_w = _split_bwd(kind, p_bwd(xs32, p, RATE, dz.float()))
        torch.cuda.synchronize()
        in_gates = []
        for i, (a, b, t) in enumerate(zip(k_in, p_in, t_in)):
            e = bf16_gate(f"{name} bwd input grad {i}", a, b, t)
            # the gate again, scaled by max |truth|: a zero or mis-wired
            # gradient is ~1 from the truth here
            top = t.float().abs().max().item()
            e_k = (a.float() - t.float()).abs().max().item() / top
            e_p = (b.float() - t.float()).abs().max().item() / top
            u = ulp_distance(a, b)[1]
            u_twin = ulp_distance(b, t)[1]      # the twin from the truth
            limit = u_twin if chain_ulps is None else chain_ulps
            if not (e_k <= 2.0 * e_p + 1e-3 and u <= limit):
                raise AssertionError(
                    f"{name} bwd input grad {i}: err from f32 {e_k:.2e} of "
                    f"max |truth| vs plain bf16 {e_p:.2e}; {u:.2f} ulps from "
                    f"plain bf16 (<= {limit:.2f}), which is {u_twin:.2f} "
                    f"ulps from the f32 truth")
            in_gates.append((e, e_k, e_p, u, u_twin))
        w_worst = 0.0
        for f, a, b, t in zip(p._fields, k_w, p_w, t_w):
            top = b.abs().max().item()
            rel = (a - b).abs().max().item() / top
            scale = max(t.abs().max().item(), 1e-30)
            e_k = (a - t).abs().max().item() / scale
            e_p = (b - t).abs().max().item() / scale
            if not (rel <= WGRAD_REL and e_k <= 2.0 * e_p + 1e-3):
                raise AssertionError(
                    f"{name} bwd d{f}: {rel:.2e} of max |plain bf16| (<= "
                    f"{WGRAD_REL}), err from f32 {e_k:.2e} vs plain bf16 "
                    f"{e_p:.2e}")
            w_worst = max(w_worst, rel)
        del t_in, t_w
        # the same backward (the training path's wiring) with its stage
        # hook: every kernel's output is recorded and replaced by the plain
        # twin's same intermediate, so each kernel runs on the twin's inputs
        seen = {}

        def hook(stage, t):
            want = taps[stage].reshape(t.shape).contiguous()
            if want.dtype != t.dtype:
                raise AssertionError(f"{name} stage {stage}: the twin's "
                                     f"{want.dtype} for the kernel's "
                                     f"{t.dtype}")
            seen[stage] = (t, want)
            return want

        _, s_w = _split_bwd(kind, k_bwd(xs, p, RATE, dz, hook))
        torch.cuda.synchronize()
        if len(seen) != STAGES[kind]:
            raise AssertionError(f"{name} bwd: the stage hook saw "
                                 f"{sorted(seen)}, {STAGES[kind]} expected")
        stage_ulps = {k: ulp_distance(a, b)[1] for k, (a, b) in seen.items()}
        worst = max(stage_ulps, key=stage_ulps.get)
        if not stage_ulps[worst] <= ULPS:
            raise AssertionError(f"{name} bwd stage {worst}: "
                                 f"{stage_ulps[worst]:.2f} ulps from the "
                                 f"plain twin on its inputs > {ULPS}")
        sw_worst = 0.0
        for f, a, b in zip(p._fields, s_w, p_w):
            rel = (a - b).abs().max().item() / b.abs().max().item()
            if not rel <= STAGE_WGRAD_REL:
                raise AssertionError(f"{name} bwd d{f} on the plain twin's "
                                     f"inputs: {rel:.2e} of max |plain| > "
                                     f"{STAGE_WGRAD_REL}")
            sw_worst = max(sw_worst, rel)
        bwd_err = max((a - b).abs().max().item() for a, b in zip(k_in, p_in))
        del seen, s_w, taps, p_in, p_w
        fwd_ms = cuda_ms(lambda: k_fwd(xs, p, RATE))
        fwd_plain_ms = cuda_ms(lambda: p_fwd(xs, p, RATE), iters=2)
        bwd_ms = cuda_ms(lambda: k_bwd(xs, p, RATE, dz), iters=3)
        bwd_plain_ms = cuda_ms(lambda: p_bwd(xs, p, RATE, dz), iters=1)
        flops = layer_flops(kind, n, lq, lk, hid, pf)
        w_bytes = nbytes(*p)
        io = nbytes(*xs)
        chain = max(gate[3] for gate in in_gates)
        held(name, torch.bfloat16, hid // heads)
        held(bwd_name(name), torch.bfloat16, hid // heads)
        results[name] = dict(
            max_abs_err=err, ms=fwd_ms, plain_ms=fwd_plain_ms,
            **bound(io + w_bytes + nbytes(got), flops), library_ms=None,
            sdpa_piece_ms=sdpa_ms(n, lq, lk, heads, dev, backward=False,
                                  d=hid // heads),
            gate=f"{ulps:.2f} bf16 ulps from plain bf16 <= {ULPS}; bf16 rel "
                 f"err from plain f32 {fe_k:.5f} <= 2 x {fe_p:.5f} + 1e-3; "
                 f"rate 0 {zero_ulps:.2f} ulps from the inference kernels")
        results[name + "_bwd"] = dict(
            max_abs_err=bwd_err, ms=bwd_ms, plain_ms=bwd_plain_ms,
            **bound(2 * io + nbytes(dz) + 2 * w_bytes, 3 * flops),
            library_ms=None,
            sdpa_piece_ms=sdpa_ms(n, lq, lk, heads, dev, backward=True,
                                  d=hid // heads),
            gate=f"input grads under the bf16 gate (also scaled by max "
                 f"|truth|) and {chain:.2f} ulps from plain bf16 (<= "
                 f"{'the twin from f32' if chain_ulps is None else chain_ulps}"
                 f"); every kernel of the backward on the plain "
                 f"twin's inputs <= {stage_ulps[worst]:.2f} ulps (<= "
                 f"{ULPS}), weight grads there <= {sw_worst:.2e} (<= "
                 f"{STAGE_WGRAD_REL}); weight grads <= {w_worst:.2e} of max "
                 f"|plain bf16| (<= {WGRAD_REL}) and under the gate; "
                 f"bit-identical runs")
        log(f"({phase}) {name} at {[tuple(x.shape) for x in xs]}, rate {RATE}: "
            f"fwd {ulps:.2f} ulps from plain bf16, gate {fe_k:.5f} vs "
            f"{fe_p:.5f}, rate 0 {zero_ulps:.2f} ulps from (c)'s kernels; "
            f"bwd input grads (gate; of max |truth|; ulps) "
            f"{[f'{e[0]:.5f}/{e[1]:.5f}; {ek:.2e}/{ep:.2e}; {u:.2f}' for e, ek, ep, u, _ in in_gates]}"
            f" (plain bf16 from f32: "
            f"{', '.join(f'{gate[4]:.2f}' for gate in in_gates)} ulps), "
            f"{len(stage_ulps)} stages <= {stage_ulps[worst]:.2f} ulps "
            f"({worst}), their weight grads <= {sw_worst:.2e}; weight "
            f"grads <= {w_worst:.2e}, deterministic")
        log(f"({phase}) {name}: fwd kernel {fwd_ms:.3f} ms, plain "
            f"{fwd_plain_ms:.3f} ms, bound {results[name]['bound_ms']:.3f} "
            f"ms; bwd kernel {bwd_ms:.3f} ms, plain {bwd_plain_ms:.3f} ms, "
            f"bound {results[name + '_bwd']['bound_ms']:.3f} ms; SDPA on the "
            f"attention piece fwd {results[name]['sdpa_piece_ms']:.3f} ms, "
            f"fwd+bwd {results[name + '_bwd']['sdpa_piece_ms']:.3f} ms")
        del xs, xs32, got, plain16, kb, k_in, k_w, dz
        torch.cuda.empty_cache()
    return results


def check_layers(cfg, packed, packed32, spec, dev,
                 phase: str = "c") -> dict:
    """(c): K2-K5 against their plain bf16 versions and the f32 truth at
    the batch-32 shapes of ``cfg``'s engine (K2 on random and on the real
    windows ``spec``), and K2's stem kernel alone."""
    from nylon_amt_tpu_torch.ops import layer_fused as lf
    from nylon_amt_tpu_torch.ops.precision import full_f32

    results = {}
    m = cfg.model
    hid, n_frame = m.hid_dim, cfg.input.num_frame
    g = torch.Generator(device=dev).manual_seed(SEED)

    def act(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def stem_layer(fn, pos, dt):
        return lambda s, p, heads: fn(s, packed.k_eff, packed.b_eff, pos, p,
                                      heads, n_frame, dt)

    k2 = (stem_layer(lf.encoder_layer_with_stem, packed.pos_freq,
                     torch.bfloat16),
          stem_layer(lf.encoder_layer_with_stem_plain, packed.pos_freq,
                     torch.bfloat16),
          stem_layer(lf.encoder_layer_with_stem_plain, packed32.pos_freq,
                     torch.float32))
    spec_t = spec.transpose(1, 2).contiguous()       # the real windows
    checks = {  # name: kernel, plain bf16, plain f32, inputs, bf16/f32 params
        "encoder_layer_with_stem": (
            *k2, lambda: (torch.randn((BATCH, cfg.window_frames, 256),
                                      generator=g, device=dev),),
            packed.enc[0], packed32.enc[0], m.enc_head),
        "encoder_layer_with_stem/windows": (
            *k2, lambda: (spec_t,), packed.enc[0], packed32.enc[0],
            m.enc_head),
        "encoder_layer": (lf.encoder_layer, lf.encoder_layer_plain,
                          lf.encoder_layer_plain,
                          lambda: (act(BATCH * n_frame, 256, hid),),
                          packed.enc[1], packed32.enc[1], m.enc_head),
        "encoder_layer/time": (lf.encoder_layer, lf.encoder_layer_plain,
                               lf.encoder_layer_plain,
                               lambda: (act(BATCH * 88, n_frame, hid),),
                               packed.time[0], packed32.time[0], m.dec_head),
        "decoder_layer_zero": (lf.decoder_layer_zero,
                               lf.decoder_layer_zero_plain,
                               lf.decoder_layer_zero_plain,
                               lambda: (act(BATCH * n_frame, 88, hid),
                                        act(BATCH * n_frame, 256, hid)),
                               packed.dec_zero, packed32.dec_zero, m.dec_head),
        "decoder_layer": (lf.decoder_layer, lf.decoder_layer_plain,
                          lf.decoder_layer_plain,
                          lambda: (act(BATCH * n_frame, 88, hid),
                                   act(BATCH * n_frame, 256, hid)),
                          packed.dec[0], packed32.dec[0], m.dec_head),
    }
    pf = m.pf_dim
    n_proc = packed.k_eff.shape[0]
    shapes = {  # layer kind, n, lq, lk; the stem's f32 FLOPs
        "encoder_layer_with_stem": ("enc", BATCH * n_frame, 256, 256,
                                    2 * BATCH * n_frame * 256 * n_proc * hid),
        "encoder_layer": ("enc", BATCH * n_frame, 256, 256, 0),
        "encoder_layer/time": ("enc", BATCH * 88, n_frame, n_frame, 0),
        "decoder_layer_zero": ("dec_zero", BATCH * n_frame, 88, 256, 0),
        "decoder_layer": ("dec", BATCH * n_frame, 88, 256, 0)}
    shapes["encoder_layer_with_stem/windows"] = \
        shapes["encoder_layer_with_stem"]
    for name, (fn, plain, plain32, make, p16, p32, heads) in checks.items():
        xs = make()
        got = fn(*xs, p16, heads)
        plain16 = plain(*xs, p16, heads)
        with full_f32():
            truth = plain32(*(x.float() for x in xs), p32, heads)
        torch.cuda.synchronize()
        e_k, e_p = bf16_gate(name, got, plain16, truth)
        del truth
        err, ulps = ulp_distance(got, plain16)
        if not ulps <= ULPS:
            raise AssertionError(f"{name}: kernel vs plain bf16 {err} = "
                                 f"{ulps:.2f} ulps > {ULPS}")
        ms = cuda_ms(lambda: fn(*xs, p16, heads))
        plain_ms = cuda_ms(lambda: plain(*xs, p16, heads))
        kind, n, lq, lk, stem_flops = shapes[name]
        weights = [t for t in p16 if t.numel()]
        if stem_flops:
            weights += [packed.k_eff, packed.b_eff, packed.pos_freq]
        piece = sdpa_ms(n, lq, lk, heads, dev, backward=False,
                        d=hid // heads)
        held(name, torch.bfloat16, hid // heads)
        results[name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            **bound(nbytes(*xs, *weights, got),
                    layer_flops(kind, n, lq, lk, hid, pf), stem_flops),
            library_ms=None, sdpa_piece_ms=piece,
            gate=f"bf16 rel err from plain f32 {e_k:.5f} <= 2 x plain bf16 "
                 f"{e_p:.5f} + 1e-3; {ulps:.2f} bf16 ulps from plain bf16 "
                 f"<= {ULPS}")
        log(f"({phase}) {name} at {[tuple(x.shape) for x in xs]}: gate err {e_k:.5f} vs plain bf16 "
            f"{e_p:.5f}; vs plain bf16 max abs {err:.3e} = {ulps:.2f} ulps; "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{results[name]['bound_ms']:.3f} ms ({results[name]['bound_by']}"
            f"); SDPA on its attention piece {piece:.3f} ms")
        del xs, got, plain16
    # K2's stem kernel alone (its private entry: these launches count
    # nowhere), on the real windows
    stem = (spec_t, packed.k_eff, packed.b_eff, packed.pos_freq, n_frame)
    err, ulps = ulp_distance(lf._stem_embed(*stem, torch.bfloat16),
                             lf.stem_embed_plain(*stem, torch.bfloat16))
    if not ulps <= ULPS:
        raise AssertionError(f"stem kernel vs plain bf16 {err} = {ulps:.2f} "
                             f"ulps > {ULPS}")
    stem_ms = cuda_ms(lambda: lf._stem_embed(*stem, torch.bfloat16))
    stem_plain_ms = cuda_ms(lambda: lf.stem_embed_plain(*stem,
                                                        torch.bfloat16))
    log(f"({phase}) K2's stem kernel alone: vs plain bf16 max abs {err:.3e} = "
        f"{ulps:.2f} ulps; kernel {stem_ms:.3f} ms, plain (f32 conv + bias, "
        f"scale, pos) {stem_plain_ms:.3f} ms")
    return results


def write_corpus(cfg, feat, corpus: Path) -> None:
    """Seeded train and valid splits under ``corpus``: real log-mel features
    of the smoke's audio with sparse random labels. n_slice keeps one
    window start in n_slice: 768 train frames -> 48 windows (6 steps of
    8), 256 valid frames -> 16 windows (2 validation batches)."""
    from nylon_amt_tpu_torch.data.corpus import assemble_split

    rng = np.random.default_rng(SEED + 4)
    feats = feat.cpu().numpy()

    def piece(lo, n):
        labels = {"onset": (rng.random((n, 88)) > 0.98).astype(np.float32),
                  "offset": (rng.random((n, 88)) > 0.98).astype(np.float32),
                  "mpe": rng.random((n, 88)) > 0.9,
                  "velocity": rng.integers(0, 128, (n, 88)).astype(np.int8)}
        return feats[lo:lo + n], labels

    splits = {"train": [piece(0, 400), piece(1000, 368)],
              "valid": [piece(3000, 256)]}
    for split, pieces in splits.items():
        assemble_split(cfg, [f for f, _ in pieces],
                       [lab for _, lab in pieces]).save(str(corpus), split)


def train_through_cli(cfg, feat, audio, cli_main) -> tuple[dict, dict]:
    """(i): seeded train/valid splits (:func:`write_corpus`), ``train
    --epochs 1 --device cuda``, the launch counts per step, and
    ``transcribe`` with the trained checkpoint. Returns (launch counts of
    the training run, first train batch)."""
    from nylon_amt_tpu_torch import kernels
    from nylon_amt_tpu_torch.data.corpus import SplitArrays
    from nylon_amt_tpu_torch.data.windows import WindowDataset
    from nylon_amt_tpu_torch.utils.wavio import save_wav

    m, t = cfg.model, cfg.train
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        cfg.save(str(tmp / "config.json"))
        write_corpus(cfg, feat, tmp / "corpus")
        ds = WindowDataset(SplitArrays.load(str(tmp / "corpus"), "train"),
                           cfg, n_slice=t.n_slice)
        steps = ds.steps_per_epoch
        first = next(ds.batches(t.batch_size))
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = cli_main(["train", "--config", str(tmp / "config.json"),
                       "--dataset", str(tmp / "corpus"), "--out",
                       str(tmp / "run"), "--epochs", "1", "--n-slice",
                       str(t.n_slice), "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.launches)
        if rc != 0:
            raise AssertionError(f"train returned {rc}")
        perf = json.loads((tmp / "run" / "performance.json").read_text())
        losses = perf["loss_train"] + perf["loss_valid"]
        if len(losses) != 2 or not all(map(math.isfinite, losses)):
            raise AssertionError(f"performance.json losses {losses}")
        per_step = {"hash_keep_mask": 4,     # emb_drop: 2 stages x fwd, bwd
                    "encoder_layer_train": m.enc_layer + m.dec_layer,
                    "encoder_layer_train_bwd": m.enc_layer + m.dec_layer,
                    "decoder_layer_zero_train": 1,
                    "decoder_layer_zero_train_bwd": 1,
                    "decoder_layer_train": m.dec_layer - 1,
                    "decoder_layer_train_bwd": m.dec_layer - 1}
        want = {k: v * steps for k, v in per_step.items()}
        got = {k: counts[k] for k in want}
        if got != want or steps != 6:
            raise AssertionError(f"launch counts of the training run {got}, "
                                 f"expected {want} ({steps} steps)")
        log(f"(i) cli train, paper bf16, dropout {m.dropout}, batch "
            f"{t.batch_size}: {len(ds)} train windows = {steps} steps, 1 "
            f"epoch in {wall:.2f} s wall (model init, validation and the "
            f"checkpoint included); loss train {perf['loss_train'][0]:.5f}, "
            f"valid {perf['loss_valid'][0]:.5f}; launches per step "
            f"{per_step}")
        save_wav(str(tmp / "piece.wav"), audio, SR)
        ckpt = tmp / "run" / "checkpoints" / "model_000_000" / "model.dat"
        rc = cli_main(["transcribe", "--checkpoint", str(ckpt), "--config",
                       str(tmp / "config.json"), "--wav",
                       str(tmp / "piece.wav"), "--out", str(tmp / "out"),
                       "--batch-windows", str(BATCH), "--device", "cuda"])
        if rc != 0:
            raise AssertionError(f"transcribe with the trained checkpoint "
                                 f"returned {rc}")
        notes = json.loads((tmp / "out" / "piece.notes.json").read_text())
        log(f"(i) transcribe with the trained checkpoint: {len(notes)} notes")
    return counts, first


def time_train_step(cfg, batch_np, dev, card: str, phase: str = "j",
                    what: str = "") -> float:
    """(j): the batch-8 paper bf16 train step by CUDA events, and the
    device time per kernel over a few steps; the step's forward is the one
    the trainer routes ``cfg`` to (``step.make_apply``: the fused layers,
    or in (l) the per-site forward)."""
    from nylon_amt_tpu_torch.train import step as st

    state = st.create_train_state(cfg, SEED, dev)
    batch = st.to_device(batch_np, dev)
    gen = torch.Generator().manual_seed(SEED)
    apply, draw = st.make_apply(cfg)

    def step():
        st.train_step(cfg, state, batch, draw(cfg, gen), apply)

    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(step, iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"({phase}) batch-{cfg.train.batch_size} {cfg.model.compute_dtype} "
        f"{what}train step "
        f"(dropout {cfg.model.dropout}): {ms:.3f} ms by CUDA events (mean of "
        f"10 after 2), {cfg.train.batch_size / ms * 1e3:.1f} windows/s, peak "
        f"device memory {peak:.2f} GiB; card {card}")
    profile_forward(step, iters=3, phase=phase, what="train step", top=16)
    return ms


Q8_SOURCES = {  # K13 wrapper -> the TPU kernel's pallas_call line
    "encoder_layer_with_stem_q8": "nylon_amt_tpu/ops/layer_fused_q8.py:329",
    "encoder_layer_q8": "nylon_amt_tpu/ops/layer_fused_q8.py:297",
    "decoder_layer_zero_q8": "nylon_amt_tpu/ops/layer_fused_q8.py:354",
    "decoder_layer_q8": "nylon_amt_tpu/ops/layer_fused_q8.py:378"}


def synth_notes(seconds: float) -> list[dict]:
    """The notes that ``synth_audio`` plays (each sounds 1 s)."""
    pitches = (48, 55, 60, 64, 67, 72, 76)
    return [{"pitch": pitches[i % len(pitches)], "onset": float(start),
             "offset": float(start + 1.0), "velocity": 80}
            for i, start in enumerate(np.arange(0.0, seconds - 1.0, 0.25))]


def int_mm_ms(gemms, dev) -> float:
    """Time of ``torch._int_mm`` (s8 x s8 -> s32) on a layer's GEMM shapes
    ``[(M, K, N), ...]``, one call each: the library yardstick of K13's
    GEMMs (the port never calls it)."""
    g = torch.Generator(device=dev).manual_seed(2)
    ops = [(torch.randint(-127, 128, (m, k), generator=g, device=dev,
                          dtype=torch.int8),
            torch.randint(-127, 128, (k, n), generator=g, device=dev,
                          dtype=torch.int8)) for m, k, n in gemms]
    return cuda_ms(lambda: [torch._int_mm(a, b) for a, b in ops], iters=5)


def check_int8(cfg, model, packed, spec, audio, dev, card, cli_main
               ) -> tuple[dict, dict]:
    """(k): K13, the int8 (W8A8) layers: the quantizers on the card bit for
    bit; each wrapper against its plain q8 version and the exact bf16
    layer; the int8 forward against the bf16 forward; ``transcribe --int8
    --list --tab --sheet --save-posteriors`` and ``evaluate`` through the
    CLI with the launch counts; times, a profile and the ``torch._int_mm``
    yardstick. Returns (launch counts of the CLI run, results)."""
    from nylon_amt_tpu_torch import kernels
    from nylon_amt_tpu_torch.data.lists import CorpusList
    from nylon_amt_tpu_torch.infer import engine
    from nylon_amt_tpu_torch.midi.smf import write_notes
    from nylon_amt_tpu_torch.ops import layer_fused as lf
    from nylon_amt_tpu_torch.ops import layer_fused_q8 as lq
    from nylon_amt_tpu_torch.utils.wavio import save_wav

    m = cfg.model
    hid, pf, n_frame = m.hid_dim, m.pf_dim, cfg.input.num_frame
    packed8 = engine.pack_params(model, torch.bfloat16, precision="int8")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)

    def act(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    # (1) the quantizers, bit for bit, at the layer's shapes: rows of the
    # layer input, of the packed QKV (Q and K segments in one call) and of
    # the FFN hidden; V's columns over each 256-key sequence
    x = act(BATCH * n_frame * 256, 3 * hid)
    rows = {"input": (x[:, :hid], 1), "Q/K of QKV": (x[:, :2 * hid], 2),
            "FFN hidden": (x[:, :pf], 1)}
    for what, (t, n_seg) in rows.items():
        q, s = lq.quant_rows_cuda(t, n_seg)
        for j, seg in enumerate(t.split(t.shape[1] // n_seg, dim=1)):
            pq, ps = lq._quant_rows(seg)
            width = seg.shape[1]
            if not (torch.equal(q[:, j * width:(j + 1) * width], pq)
                    and torch.equal(s[j], ps[:, 0])):
                raise AssertionError(f"K13 row quantizer ({what}, segment "
                                     f"{j}) differs from the plain version")
    v = x[:, 2 * hid:]
    vt, sv = lq.quant_cols_cuda(v, BATCH * n_frame)
    pv, psv = lq._quant_cols(v.reshape(BATCH * n_frame, 256, hid))
    if not (torch.equal(vt.transpose(1, 2), pv)
            and torch.equal(sv, psv[:, 0])):
        raise AssertionError("K13 column quantizer differs from the plain "
                             "version")
    q_ms = cuda_ms(lambda: lq.quant_rows_cuda(x[:, :hid]), iters=10)
    log(f"(k) K13 quantizers bit-identical to the plain versions: rows "
        f"[{x.shape[0]}, {hid}] / Q,K [{x.shape[0]}, 2 x {hid}] / "
        f"[{x.shape[0]}, {pf}], V columns of {BATCH * n_frame} sequences; "
        f"row quantizer {q_ms:.3f} ms at [{x.shape[0]}, {hid}]")
    del x, v, q, s, pq, ps, vt, sv, pv, psv

    # (2) each wrapper against its plain q8 version and the exact layer
    def stem(fn):
        return lambda s_, p, heads: fn(s_, packed.k_eff, packed.b_eff,
                                       packed.pos_freq, p, heads, n_frame,
                                       torch.bfloat16)

    spec_t = spec.transpose(1, 2).contiguous()
    n_f, n_t = BATCH * n_frame, BATCH * 88
    k2 = (stem(lq.encoder_layer_with_stem_q8),
          stem(lq.encoder_layer_with_stem_q8_plain),
          stem(lf.encoder_layer_with_stem))
    checks = {  # kernel, plain q8, exact bf16 kernel, inputs, p8, p16, heads
        "encoder_layer_with_stem_q8": (
            *k2, lambda: (torch.randn((BATCH, cfg.window_frames, 256),
                                      generator=g, device=dev),),
            packed8.enc[0], packed.enc[0], m.enc_head),
        "encoder_layer_with_stem_q8/windows": (
            *k2, lambda: (spec_t,), packed8.enc[0], packed.enc[0],
            m.enc_head),
        "encoder_layer_q8": (lq.encoder_layer_q8, lq.encoder_layer_q8_plain,
                             lf.encoder_layer,
                             lambda: (act(n_f, 256, hid),), packed8.enc[1],
                             packed.enc[1], m.enc_head),
        "encoder_layer_q8/time": (lq.encoder_layer_q8,
                                  lq.encoder_layer_q8_plain, lf.encoder_layer,
                                  lambda: (act(n_t, n_frame, hid),),
                                  packed8.time[0], packed.time[0],
                                  m.dec_head),
        "decoder_layer_zero_q8": (lq.decoder_layer_zero_q8,
                                  lq.decoder_layer_zero_q8_plain,
                                  lf.decoder_layer_zero,
                                  lambda: (act(n_f, 88, hid),
                                           act(n_f, 256, hid)),
                                  packed8.dec_zero, packed.dec_zero,
                                  m.dec_head),
        "decoder_layer_q8": (lq.decoder_layer_q8, lq.decoder_layer_q8_plain,
                             lf.decoder_layer,
                             lambda: (act(n_f, 88, hid), act(n_f, 256, hid)),
                             packed8.dec[0], packed.dec[0], m.dec_head)}
    n_proc = packed.k_eff.shape[0]
    shapes = {  # kind, n, lq, lk, stem f32 FLOPs, GEMMs (M, K, N)
        "encoder_layer_with_stem_q8": ("enc", n_f, 256, 256,
                                       2 * n_f * 256 * n_proc * hid),
        "encoder_layer_q8": ("enc", n_f, 256, 256, 0),
        "encoder_layer_q8/time": ("enc", n_t, n_frame, n_frame, 0),
        "decoder_layer_zero_q8": ("dec_zero", n_f, 88, 256, 0),
        "decoder_layer_q8": ("dec", n_f, 88, 256, 0)}
    shapes["encoder_layer_with_stem_q8/windows"] = \
        shapes["encoder_layer_with_stem_q8"]
    results, failed = {}, []
    for name, (fn, plain, exact, make, p8, p16, heads) in checks.items():
        xs = make()
        got = fn(*xs, p8, heads)
        want = plain(*xs, p8, heads)
        ref = exact(*xs, p16, heads)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name}: non-finite output")
        d = (got.float() - want.float()).abs()
        ulp = bf16_ulp(want)
        share = (d <= ULPS * ulp).float().mean().item()
        err = d.max().item()
        from_exact = (got.float() - ref.float()).abs().max().item()
        plain_from_exact = (want.float() - ref.float()).abs().max().item()
        exact_limit = plain_from_exact + ULPS * bf16_ulp(ref)
        if not (share >= Q8_SHARE and err <= Q8_BUDGET
                and from_exact <= exact_limit):
            failed.append(
                f"{name}: {share:.6f} of elements within {ULPS} bf16 ulps "
                f"of the plain q8 version (>= {Q8_SHARE}), max {err:.4f} "
                f"(<= {Q8_BUDGET}); {from_exact:.4f} from the exact bf16 "
                f"layer (<= plain q8's {plain_from_exact:.4f} + {ULPS} "
                f"ulps)")
        del d, want, ref
        ms = cuda_ms(lambda: fn(*xs, p8, heads))
        plain_ms = cuda_ms(lambda: plain(*xs, p8, heads), iters=2)
        exact_ms = cuda_ms(lambda: exact(*xs, p16, heads))
        kind, n, lq_, lk, stem_flops = shapes[name]
        gemms = [(n * lq_, hid, hid), (n * lq_, hid, pf), (n * lq_, pf, hid)]
        gemms += ([(n * lq_, hid, 3 * hid)] if kind == "enc" else
                  [(n * lq_, hid, hid), (n * lk, hid, 2 * hid)])
        if kind == "dec":
            gemms += [(n * lq_, hid, 3 * hid), (n * lq_, hid, hid)]
        weights = [t for t in p8 if t.numel()]
        if stem_flops:
            weights += [packed.k_eff, packed.b_eff, packed.pos_freq]
        b = bound(nbytes(*xs, *weights, got), f32_flops=stem_flops,
                  int8_ops=layer_flops(kind, n, lq_, lk, hid, pf))
        held(name, torch.bfloat16, hid // heads)
        results[name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, **b,
            library_ms=int_mm_ms(gemms, dev), bf16_kernel_ms=exact_ms,
            gate=f"{share:.6f} of elements within {ULPS} bf16 ulps of the "
                 f"plain q8 version (>= {Q8_SHARE}), max {err:.4f} (<= "
                 f"{Q8_BUDGET}); {from_exact:.4f} from the exact bf16 layer "
                 f"(<= the plain q8 version's {plain_from_exact:.4f} + "
                 f"{ULPS} ulps)")
        log(f"(k) {name} at {[tuple(t.shape) for t in xs]}: "
            f"{results[name]['gate']}; kernel {ms:.3f} ms, plain q8 "
            f"{plain_ms:.3f} ms, bf16 kernels {exact_ms:.3f} ms, "
            f"torch._int_mm on its GEMMs {results[name]['library_ms']:.3f} "
            f"ms, bound {b['bound_ms']:.3f} ms ({b['bound_by']})")
        del xs, got
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError("; ".join(failed))

    # (3) the int8 forward against the bf16 forward, posteriors; the plain
    # q8 forward (the wrappers' plain versions on the card) shows how far
    # the W8A8 scheme itself lands from the bf16 forward
    def plain_q8_forward():
        kept = {n: getattr(lq, n) for n in Q8_SOURCES}
        try:
            for n in Q8_SOURCES:
                setattr(lq, n, getattr(lq, n + "_plain"))
            return engine.forward(packed8, spec, cfg)
        finally:
            for n, fn in kept.items():
                setattr(lq, n, fn)

    out8 = engine.forward(packed8, spec, cfg)
    out16 = engine.forward(packed, spec, cfg)
    outp = plain_q8_forward()
    worst, scheme, failed = {}, {}, []
    for k in out16:
        if k.startswith("velocity"):
            continue
        p16 = torch.sigmoid(out16[k].float())
        worst[k] = (torch.sigmoid(out8[k].float()) - p16).abs().max().item()
        scheme[k] = (torch.sigmoid(outp[k].float()) - p16).abs().max().item()
        if not (worst[k] <= Q8_FORWARD_REL * scheme[k]
                and (k.endswith("_B") or worst[k] <= Q8_POST)):
            failed.append(f"{k}: {worst[k]:.4f} from the bf16 forward, the "
                          f"plain q8 forward {scheme[k]:.4f}")
    if failed:
        raise AssertionError("int8 forward posteriors: " + "; ".join(failed))
    vel = {f: (out8[f"velocity_{f}"].argmax(-1) == out16[f"velocity_{f}"]
               .argmax(-1)).float().mean().item() for f in ("A", "B")}
    audio_s = BATCH * n_frame * cfg.feature.hop_sample / SR
    log(f"(k) batch-{BATCH} paper forward, int8 vs bf16, posteriors (plain "
        f"q8 forward vs bf16 in brackets): "
        + ", ".join(f"{k} {v:.4f} ({scheme[k]:.4f})" for k, v in worst.items())
        + f"; A heads <= {Q8_POST}, all <= {Q8_FORWARD_REL} x the plain q8 "
        f"forward's; velocity classes equal {vel['A']:.4f} / {vel['B']:.4f} "
        f"(A/B)")
    del outp, out8, out16
    ms8 = cuda_ms(lambda: engine.forward(packed8, spec, cfg), iters=10)
    ms16 = cuda_ms(lambda: engine.forward(packed, spec, cfg), iters=10)
    log(f"(k) batch-{BATCH} paper forward: int8 {ms8:.3f} ms "
        f"({audio_s / ms8 * 1e3:.1f} audio-s/s), bf16 {ms16:.3f} ms "
        f"({audio_s / ms16 * 1e3:.1f} audio-s/s); card {card}")
    profile_forward(lambda: engine.forward(packed8, spec, cfg), phase="k",
                    what="int8 forward", top=14)

    # (4) transcribe --int8 --list ... and evaluate, through the CLI
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        cfg.save(str(tmp / "config.json"))
        torch.save({"model_dict": {k: v.cpu() for k, v in
                                   model.state_dict().items()}},
                   tmp / "model.dat")
        save_wav(str(tmp / "piece.wav"), audio, SR)
        write_notes(str(tmp / "piece.mid"), synth_notes(AUDIO_SEC))
        cl = CorpusList()
        cl.add("test", "piece", str(tmp / "piece.wav"), str(tmp / "piece.mid"))
        cl.save(str(tmp / "lists"))
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = cli_main(["transcribe", "--checkpoint", str(tmp / "model.dat"),
                       "--config", str(tmp / "config.json"), "--list",
                       str(tmp / "lists"), "--split", "test", "--out",
                       str(tmp / "out"), "--batch-windows", str(BATCH),
                       "--int8", "--tab", "--sheet", "--save-posteriors",
                       "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.launches)
        if rc != 0:
            raise AssertionError(f"transcribe --int8 returned {rc}")
        for ext in (".mid", ".notes.json", ".alphatex", ".musicxml",
                    ".post.npz"):
            if not (tmp / "out" / f"piece{ext}").is_file():
                raise AssertionError(f"transcribe --int8 wrote no piece{ext}")
        post = np.load(tmp / "out" / "piece.post.npz")
        if not all(np.isfinite(post[k]).all() for k in post.files):
            raise AssertionError("non-finite posteriors in piece.post.npz")
        scores = {}
        for suffix in (".notes.json", ".post.npz"):
            with contextlib.redirect_stdout(io.StringIO()):  # read below
                rc = cli_main(["evaluate", "--config",
                               str(tmp / "config.json"), "--list",
                               str(tmp / "lists"), "--split", "test",
                               "--est-dir", str(tmp / "out"), "--suffix",
                               suffix, "--out",
                               str(tmp / f"scores{suffix}.json")])
            res = json.loads((tmp / f"scores{suffix}.json").read_text())
            key = "mpe_posterior" if suffix == ".post.npz" else "note"
            if rc != 0 or f"piece{suffix}" not in res[key]["per_file"]:
                raise AssertionError(f"evaluate {suffix}: rc {rc}, {res}")
            scores[key] = res[key]["mean"]
        notes = json.loads((tmp / "out" / "piece.notes.json").read_text())
    n_frames = 1 + int(AUDIO_SEC * SR) // cfg.feature.hop_sample
    n_batches = math.ceil(math.ceil(n_frames / n_frame) / BATCH)
    want = {"log_mel": 1, "encoder_layer_with_stem_q8": n_batches,
            "encoder_layer_q8": n_batches * (m.enc_layer - 1 + m.dec_layer),
            "decoder_layer_zero_q8": n_batches,
            "decoder_layer_q8": n_batches * (m.dec_layer - 1)}
    want.update({k: 0 for k in counts if k not in want})  # bf16 K2-K5 too
    if counts != want:
        raise AssertionError(f"launch counts of transcribe --int8 {counts}, "
                             f"expected {want}")
    ran = ", ".join(f"{k} {v}" for k, v in counts.items() if v)
    f_note = scores["note"].get("F-measure", float("nan"))
    f_mpe = scores["mpe_posterior"].get("F-measure", float("nan"))
    log(f"(k) transcribe --int8 --list --tab --sheet --save-posteriors "
        f"{AUDIO_SEC:.0f} s WAV -> {len(notes)} notes, all five artifacts; "
        f"{wall:.2f} s wall; launches {ran} ({n_batches} batches of "
        f"{BATCH}; bf16 K2-K5 0); evaluate: note F {f_note:.4f}, MPE "
        f"posterior F {f_mpe:.4f} (random weights)")
    return counts, results


# (l) the per-site attention -------------------------------------------------

PROBS_ATOL = 1e-5  # K11 probabilities vs the plain f32 ones (same bf16 q/k)
ROW_SUM_ATOL = 1e-5
ATTN_SITES = {  # name: Lq, Lk, sequences per window (paper width)
    "freq self": (256, 256, 128), "cross": (88, 256, 128),
    "note self": (88, 88, 128), "time self": (128, 128, 88)}
_ATT = "nylon_amt_tpu/ops/attention.py"
MHA_SOURCES = {  # wrapper counter -> the TPU kernel's pallas_call line
    "fused_mha": f"{_ATT}:258", "fused_mha_bwd": f"{_ATT}:286",
    "fused_mha_with_probs": f"{_ATT}:258",
    "fused_mha_with_probs_bwd": f"{_ATT}:286",
    "fused_mha_dropout": f"{_ATT}:388", "fused_mha_dropout_bwd": f"{_ATT}:412"}
# the shape each kernel's JSON row reports: the forwards of transcription
# at batch 32 and the kernels of training at batch 8
MHA_ROW_SHAPES = {"fused_mha": (BATCH, "freq self"),
                  "fused_mha_bwd": (TRAIN_BATCH, "freq self"),
                  "fused_mha_with_probs": (BATCH, "cross"),
                  "fused_mha_with_probs_bwd": (TRAIN_BATCH, "cross"),
                  "fused_mha_dropout": (TRAIN_BATCH, "freq self"),
                  "fused_mha_dropout_bwd": (TRAIN_BATCH, "freq self")}
# Times of the wmma attention kernels that csrc/mha.cu replaced (ms; PERF.md
# section 6 and its prediction for them: NVIDIA H100 80GB HBM3, 700 W; the
# batch-8 forwards from their check call, the rest from (l))
WMMA_MS = {
    ("fused_mha", BATCH, "freq self"): 4.571,
    ("fused_mha_bwd", TRAIN_BATCH, "freq self"): 6.928,
    ("fused_mha_with_probs", BATCH, "cross"): 3.158,
    ("fused_mha_with_probs_bwd", TRAIN_BATCH, "cross"): 2.964,
    ("fused_mha_dropout", TRAIN_BATCH, "freq self"): 1.202,
    ("fused_mha_dropout_bwd", TRAIN_BATCH, "freq self"): 7.805,
    ("fused_mha", TRAIN_BATCH, "freq self"): 1.185,
    ("fused_mha", TRAIN_BATCH, "cross"): 0.567,
    ("fused_mha", TRAIN_BATCH, "note self"): 0.214,
    ("fused_mha", TRAIN_BATCH, "time self"): 0.229,
    ("fused_mha_with_probs", TRAIN_BATCH, "freq self"): 1.943,
    ("fused_mha_with_probs", TRAIN_BATCH, "cross"): 0.873,
    ("fused_mha_with_probs", TRAIN_BATCH, "note self"): 0.304,
    ("fused_mha_with_probs", TRAIN_BATCH, "time self"): 0.334,
    ("fused_mha_dropout", TRAIN_BATCH, "cross"): 0.570,
    ("fused_mha_dropout", TRAIN_BATCH, "note self"): 0.268,
    ("fused_mha_dropout", TRAIN_BATCH, "time self"): 0.263,
    ("fused_mha_dropout_bwd", TRAIN_BATCH, "cross"): 3.292,
    ("fused_mha_dropout_bwd", TRAIN_BATCH, "note self"): 1.059,
    ("fused_mha_dropout_bwd", TRAIN_BATCH, "time self"): 0.944}
# Times of csrc/mha_f32.cu's all-FFMA kernels, before its products moved to
# the tensor cores, at (n.1)'s row shapes (MHA_ROW_SHAPES) per head_dim (ms;
# PERF.md section 6: NVIDIA H100 80GB HBM3, 700 W)
FFMA_F32_MS = {
    ("fused_mha", 32): 2.737, ("fused_mha_bwd", 32): 3.358,
    ("fused_mha_with_probs", 32): 1.194,
    ("fused_mha_with_probs_bwd", 32): 1.445,
    ("fused_mha_dropout", 32): 0.847, ("fused_mha_dropout_bwd", 32): 3.907,
    ("fused_mha", 64): 10.171, ("fused_mha_bwd", 64): 10.226,
    ("fused_mha_with_probs", 64): 4.689,
    ("fused_mha_with_probs_bwd", 64): 4.179,
    ("fused_mha_dropout", 64): 2.956, ("fused_mha_dropout_bwd", 64): 10.969}


def site_counts(m) -> tuple[int, int]:
    """(attention sites, activation dropout sites) of a model config: the
    embedding dropout of each stage, three sites per self-attention layer
    (attention out, FFN mid, FFN out), four per decoder layer, one per
    conv block."""
    att, act = m.enc_layer, 3 * m.enc_layer + 1
    if m.enc_alg == "cnnblock_safreq":
        act += 4
    if m.dec_alg != "linear_satime":
        att += 1 + 2 * (m.dec_layer - 1)
        act += 3 + 4 * (m.dec_layer - 1)
    if m.dec_alg != "cafreq":
        att += m.dec_layer
        act += 3 * m.dec_layer + 1
    return att, act


def _realized_masks(att, n, lq, lk, heads, d, dev, dtype=torch.bfloat16):
    """The keep pattern K12 applies (in ``dtype``), read back from its
    output: with q = 0 every probability is 1 / Lk, and V one-hot over d
    keys at a time puts key j's keep value in output column j mod d of each
    head."""
    q = torch.zeros((n, lq, heads * d), dtype=dtype, device=dev)
    keeps = torch.empty((heads, n, lq, lk), dtype=torch.bool, device=dev)
    for t0 in range(0, lk, d):
        w = min(d, lk - t0)
        v = torch.zeros((n, lk, heads * d), dtype=dtype, device=dev)
        idx = torch.arange(w, device=dev)
        for h in range(heads):
            v[:, t0 + idx, h * d + idx] = 1.0
        o = att.fused_mha_dropout(q, v, v, heads, 0.125, RATE, DROP_SEED)
        o = o.float().reshape(n, lq, heads, d)[..., :w] * lk
        keeps[..., t0:t0 + w] = (o > 0.5).permute(2, 0, 1, 3)
    return keeps


def _bwd_only_ms(fn, q, k, v, do) -> float:
    """Time of the backward alone: autograd.grad over one recorded forward
    (the graph kept between calls)."""
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    out = fn(qq, kk, vv)
    out = out[0] if isinstance(out, tuple) else out
    return cuda_ms(lambda: torch.autograd.grad(out, (qq, kk, vv), do,
                                                retain_graph=True))


def check_attention_kernels(dev, heads: int = 4, hid: int = 256,
                            phase: str = "l") -> dict:
    """(l.1), and (m.1) at head_dim 32: K10, K11 and K12 forward and
    backward against their plain versions at every per-site attention
    shape of the model (``heads`` over ``hid``), batch 8 and batch 32: the
    (c)/(h) bf16 gates, K11's probabilities, K12's realized masks bit for
    bit, bit-identical backward runs; times beside SDPA and the replaced
    wmma kernels'.
    Returns each kernel's JSON fields at its row shape ((l) only)."""
    import torch.nn.functional as F

    from nylon_amt_tpu_torch.ops import attention as att
    from nylon_amt_tpu_torch.ops.precision import full_f32

    scale = 0.125
    d = hid // heads
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    mask = lambda h, shape: att.hash_keep_mask_plain(   # noqa: E731
        DROP_SEED, h, 0, shape, RATE, torch.float32, dev)
    fns = {"fused_mha": (lambda q, k, v: att.fused_mha(q, k, v, heads, scale),
                         None),
           "fused_mha_dropout": (lambda q, k, v: att.fused_mha_dropout(
               q, k, v, heads, scale, RATE, DROP_SEED), mask)}
    rows, worst = {}, {}
    for B in (TRAIN_BATCH, BATCH):
        for site, (lq, lk, per) in ATTN_SITES.items():
            n = B * per
            q, k, v, do = (torch.randn((n, L, hid), generator=g, device=dev)
                           .to(torch.bfloat16) for L in (lq, lk, lk, lq))
            f32 = [t.float() for t in (q, k, v, do)]
            line, fields = [], {}

            def grads(fn):
                qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
                out = fn(qq, kk, vv)
                out = out[0] if isinstance(out, tuple) else out
                return torch.autograd.grad(out, (qq, kk, vv), do)

            for name, (fn, msk) in fns.items():
                got = fn(q, k, v)
                plain16 = att.mha_plain(q, k, v, heads, scale, msk)
                with full_f32():
                    truth = att.mha_plain(*f32[:3], heads, scale, msk)
                e_k, e_p = bf16_gate(f"{name} {site} B={B}", got, plain16,
                                     truth)
                err, ulps = ulp_distance(got, plain16)
                if not ulps <= ULPS:
                    raise AssertionError(f"{name} {site} B={B}: {ulps:.2f} "
                                         f"ulps from plain bf16 > {ULPS}")
                fields[name] = dict(max_abs_err=err, gate=(
                    f"{ulps:.2f} bf16 ulps from plain bf16 <= {ULPS}; bf16 "
                    f"rel err from plain f32 {e_k:.5f} <= 2 x {e_p:.5f} + "
                    f"1e-3"))
                line.append(f"{name} {ulps:.2f} ulps (gate {e_k:.4f}/"
                            f"{e_p:.4f})")
                if name == "fused_mha":
                    k10 = got
                del got, plain16, truth
                # the backward: twice (bit-identical), against the plain
                # bf16 twin and the f32 truth
                kb, kb2 = grads(fn), grads(fn)
                if not all(torch.equal(a, b) for a, b in zip(kb, kb2)):
                    raise AssertionError(f"{name} bwd {site} B={B}: two runs "
                                         f"differ")
                pb = att.mha_bwd_plain(q, k, v, do, heads, scale, msk)
                with full_f32():
                    tb = att.mha_bwd_plain(*f32, heads, scale, msk)
                us = []
                for gname, a, b, t in zip(("dq", "dk", "dv"), kb, pb, tb):
                    bf16_gate(f"{name} bwd {gname} {site} B={B}", a, b, t)
                    top = t.abs().max().item()
                    e_k = (a.float() - t).abs().max().item() / top
                    e_p = (b.float() - t).abs().max().item() / top
                    u = ulp_distance(a, b)[1]
                    if not (e_k <= 2.0 * e_p + 1e-3 and u <= CHAIN_ULPS):
                        raise AssertionError(
                            f"{name} bwd {gname} {site} B={B}: err from f32 "
                            f"{e_k:.2e} of max |truth| vs plain {e_p:.2e}; "
                            f"{u:.2f} ulps (<= {CHAIN_ULPS})")
                    us.append(u)
                fields[name + "_bwd"] = dict(
                    max_abs_err=max((a.float() - b.float()).abs().max().item()
                                    for a, b in zip(kb, pb)),
                    gate=(f"dq/dk/dv {max(us):.2f} bf16 ulps from plain bf16 "
                          f"(<= {CHAIN_ULPS}), under the f32-truth gate and "
                          f"the gate scaled by max |truth|; bit-identical "
                          f"runs"))
                line.append(f"{name}_bwd {max(us):.2f} ulps")
                if name == "fused_mha":
                    k10b, k10pb = kb, pb
                del kb, kb2, pb, tb
            # K11: K10's output bit for bit, its probabilities against the
            # plain f32 ones, rows summing to 1; its own backward (the
            # output cotangent only: K10's kernel) against the plain one
            k11 = lambda a, b, c: att.fused_mha_with_probs(  # noqa: E731
                a, b, c, heads, scale)
            o11, probs = k11(q, k, v)
            _, p_plain = att.mha_plain(q, k, v, heads, scale,
                                       with_probs=True)
            p_err = (probs - p_plain).abs().max().item()
            r_err = (probs.sum(-1) - 1.0).abs().max().item()
            worst["probs"] = max(worst.get("probs", 0.0), p_err)
            k11b = grads(k11)
            same_b = all(torch.equal(a, b) for a, b in zip(k11b, k10b))
            if not (torch.equal(o11, k10) and p_err <= PROBS_ATOL
                    and r_err <= ROW_SUM_ATOL and same_b):
                raise AssertionError(
                    f"fused_mha_with_probs {site} B={B}: output equal to "
                    f"K10's {torch.equal(o11, k10)}, probs {p_err:.2e} from "
                    f"plain f32 (<= {PROBS_ATOL}), rows sum to 1 +- "
                    f"{r_err:.2e} (<= {ROW_SUM_ATOL}), backward equal to "
                    f"K10's {same_b}")
            fields["fused_mha_with_probs"] = dict(
                max_abs_err=p_err, gate=(
                    f"output bit-identical to K10's; probs {p_err:.2e} from "
                    f"the plain f32 probs (<= {PROBS_ATOL}); rows sum to 1 "
                    f"+- {r_err:.2e} (<= {ROW_SUM_ATOL})"))
            fields["fused_mha_with_probs_bwd"] = dict(
                max_abs_err=max((a.float() - b.float()).abs().max().item()
                                for a, b in zip(k11b, k10pb)),
                gate=("dq/dk/dv from the output cotangent bit-identical to "
                      "K10's backward (the same kernel), so within its "
                      "gates"))
            line.append(f"K11 probs {p_err:.2e}, rows {r_err:.2e}")
            for name in MHA_SOURCES:
                held(name, torch.bfloat16, d)
            del o11, probs, p_plain
            # K12's realized masks, bit for bit (batch 8)
            if B == TRAIN_BATCH:
                keeps = _realized_masks(att, n, lq, lk, heads, d, dev)
                for h in range(heads):
                    if not torch.equal(keeps[h], mask(h, (n, lq, lk)) != 0):
                        raise AssertionError(f"K12 {site}: head {h}'s mask "
                                             f"differs from the plain one")
                line.append(f"K12 masks bit-identical "
                            f"({'packed' if lk % 256 == 0 else 'unpacked'}, "
                            f"keep {keeps.float().mean().item():.4f})")
                del keeps
            # times: kernels and SDPA here; plain versions at the row shapes
            qh, kh, vh = (t.view(n, -1, heads, d).transpose(1, 2)
                          for t in (q, k, v))
            sd = lambda *a, **kw: F.scaled_dot_product_attention(  # noqa
                *a, **kw).transpose(1, 2).reshape(n, lq, hid)
            ms = {"fused_mha": cuda_ms(lambda: fns["fused_mha"][0](q, k, v)),
                  "fused_mha_with_probs": cuda_ms(
                      lambda: att.fused_mha_with_probs(q, k, v, heads,
                                                       scale)),
                  "fused_mha_dropout": cuda_ms(
                      lambda: fns["fused_mha_dropout"][0](q, k, v))}
            ms["fused_mha_bwd"] = _bwd_only_ms(fns["fused_mha"][0], q, k, v,
                                               do)
            ms["fused_mha_with_probs_bwd"] = _bwd_only_ms(k11, q, k, v, do)
            ms["fused_mha_dropout_bwd"] = _bwd_only_ms(
                fns["fused_mha_dropout"][0], q, k, v, do)
            lib = {"fused_mha": cuda_ms(lambda: sd(qh, kh, vh)),
                   "fused_mha_dropout": cuda_ms(
                       lambda: sd(qh, kh, vh, dropout_p=RATE)),
                   "fused_mha_with_probs": None}
            lib["fused_mha_bwd"] = _bwd_only_ms(
                lambda a, b, c: F.scaled_dot_product_attention(
                    *(t.view(n, -1, heads, d).transpose(1, 2)
                      for t in (a, b, c))).transpose(1, 2).reshape(n, lq,
                                                                   hid),
                q, k, v, do)
            # K11's backward from the output cotangent is K10's function
            lib["fused_mha_with_probs_bwd"] = lib["fused_mha_bwd"]
            lib["fused_mha_dropout_bwd"] = _bwd_only_ms(
                lambda a, b, c: F.scaled_dot_product_attention(
                    *(t.view(n, -1, heads, d).transpose(1, 2)
                      for t in (a, b, c)), dropout_p=RATE)
                .transpose(1, 2).reshape(n, lq, hid), q, k, v, do)
            log(f"({phase}) [{n}, {lq}, {lk}] x {heads} heads of {d} "
                f"({site}, batch {B}): " + "; ".join(line))
            log(f"({phase})   ms " + ", ".join(
                f"{k_} {v_:.3f}" + (f" (SDPA {lib[k_]:.3f})"
                                    if lib[k_] is not None else "")
                + (f" (wmma {WMMA_MS[k_, B, site]:.3f}: "
                   f"{WMMA_MS[k_, B, site] / v_:.2f}x)"
                   if d == 64 and (k_, B, site) in WMMA_MS else "")
                for k_, v_ in ms.items()))
            for name, (b_, s_) in MHA_ROW_SHAPES.items():
                if phase != "l" or (b_, s_) != (B, site):
                    continue
                msk = mask if "dropout" in name else None
                if name.endswith("_bwd"):
                    plain_ms = cuda_ms(lambda: att.mha_bwd_plain(
                        q, k, v, do, heads, scale, msk), iters=1)
                    nb = nbytes(q, k, v, do, q, k, v)       # dq, dk, dv
                    products = 5
                else:
                    plain_ms = cuda_ms(lambda: att.mha_plain(
                        q, k, v, heads, scale, msk,
                        with_probs=name == "fused_mha_with_probs"), iters=1)
                    nb = nbytes(q, k, v, q)
                    if name == "fused_mha_with_probs":
                        nb += n * heads * lq * lk * 4
                    products = 2
                flops = 2 * products * n * heads * lq * lk * d
                hash_ops = 8 * n * heads * lq * lk if msk else 0
                rows[name] = dict(
                    max_abs_err=fields[name]["max_abs_err"], ms=ms[name],
                    plain_ms=plain_ms,
                    **bound(nb, flops, f32_flops=hash_ops),
                    library_ms=lib[name], shape=[n, lq, lk],
                    gate=fields[name]["gate"])
            del q, k, v, do, f32, qh, kh, vh, k10, k10b, k10pb, k11b
            torch.cuda.empty_cache()
    log(f"({phase}) K11 probabilities: max {worst['probs']:.2e} from the "
        f"plain f32 ones over all shapes (<= {PROBS_ATOL})")
    return rows


def check_return_attention_forward(cfg, model, packed, spec, dev,
                                   engine_ms: float) -> None:
    """(l.2): a batch-32 paper forward of a ``return_attention`` config
    through the per-site path (10 K10 + 1 K11 launches, no K2-K5) against
    the engine's forward on the same weights, within (e)'s 8 / 64 ulps; the
    attention map's shape and rows; its time beside the engine's."""
    from nylon_amt_tpu_torch import kernels
    from nylon_amt_tpu_torch.infer import engine
    from nylon_amt_tpu_torch.models.hft import build_model

    cfg_ra = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, return_attention=True))
    model_ra = build_model(cfg_ra, dev)
    model_ra.load_state_dict(model.state_dict())
    with torch.no_grad():
        ref = engine.forward(packed, spec, cfg)
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = model_ra.per_site(spec)
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launches.items() if v}
    want = {"fused_mha": 10, "fused_mha_with_probs": 1}
    if counts != want:
        raise AssertionError(f"per-site forward launches {counts}, expected "
                             f"{want}")
    failed, line = [], []
    for k, r in ref.items():
        err, ulps = ulp_distance(out[k], r)
        bound_ = ULPS_FORWARD[k[-1]]
        if not ulps <= bound_:
            failed.append(f"{k} {ulps:.1f} ulps > {bound_}")
        line.append(f"{k} {ulps:.1f}")
    attn = out["attention"]
    rows = (attn.sum(-1) - 1.0).abs().max().item()
    if (tuple(attn.shape) != (BATCH, cfg.input.num_frame, 4, 88, 256)
            or not rows <= ROW_SUM_ATOL):
        failed.append(f"attention {tuple(attn.shape)}, rows {rows:.2e}")
    if failed:
        raise AssertionError("per-site forward vs engine: "
                             + "; ".join(failed))
    del out, ref, attn
    with torch.no_grad():
        ms = cuda_ms(lambda: model_ra.per_site(spec), iters=5)
    audio_s = BATCH * cfg.input.num_frame * cfg.feature.hop_sample / SR
    log(f"(l) batch-{BATCH} return_attention forward, per-site path: "
        f"launches {counts}; vs the engine's forward (ulps of max |engine|, "
        f"<= 8 / 64): " + ", ".join(line) + f"; attention map "
        f"[{BATCH}, 128, 4, 88, 256], rows sum to 1 +- {rows:.2e}; "
        f"{ms:.3f} ms ({audio_s / ms * 1e3:.1f} audio-s/s) against the "
        f"engine's {engine_ms:.3f} ms")
    profile_forward(lambda: model_ra.per_site(spec), iters=5, phase="l",
                    what="forward", top=12)
    del model_ra
    torch.cuda.empty_cache()


def per_site_through_cli(cfg, feat, audio, dev, card, cli_main
                         ) -> tuple[dict, dict]:
    """(l.3): ``cli train --epochs 1 --device cuda`` and ``cli transcribe``
    with its checkpoint, for ``--remat`` (dropout 0.1), a
    ``return_attention`` config at dropout 0 (K10's and K11's backward),
    1FLT and 2FDT (dropout 0.1): the launch counts of each run, finite
    losses, BatchNorm statistics that moved. Returns (the launch counts of
    the remat and return_attention trainings, first train batch)."""
    from nylon_amt_tpu_torch import kernels
    from nylon_amt_tpu_torch.data.corpus import SplitArrays
    from nylon_amt_tpu_torch.data.windows import WindowDataset
    from nylon_amt_tpu_torch.utils.wavio import save_wav

    rep = dataclasses.replace
    runs = {  # name: model overrides, extra CLI flags
        "remat": ({}, ["--remat"]),
        "return_attention": (dict(return_attention=True, dropout=0.0), []),
        "1FLT": (dict(dec_alg="linear_satime"), []),
        "2FDT": (dict(enc_alg="cnnblock_safreq"), [])}
    n_frames = 1 + int(AUDIO_SEC * SR) // cfg.feature.hop_sample
    n_batches = math.ceil(math.ceil(n_frames / cfg.input.num_frame) / BATCH)
    train_k = ("encoder_layer_train", "decoder_layer_zero_train",
               "decoder_layer_train")
    main_counts = {}
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        write_corpus(cfg, feat, tmp / "corpus")
        ds = WindowDataset(SplitArrays.load(str(tmp / "corpus"), "train"),
                           cfg, n_slice=cfg.train.n_slice)
        steps = ds.steps_per_epoch
        first = next(ds.batches(cfg.train.batch_size))
        n_valid = 2                      # 16 valid windows, batch 8
        save_wav(str(tmp / "piece.wav"), audio, SR)
        for name, (over, extra) in runs.items():
            c = rep(cfg, model=rep(cfg.model, **over))
            c.save(str(tmp / f"{name}.json"))
            m = rep(c.model, remat=bool(extra))
            att, act = site_counts(m)
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            rc = cli_main(["train", "--config", str(tmp / f"{name}.json"),
                           "--dataset", str(tmp / "corpus"), "--out",
                           str(tmp / name), "--epochs", "1", "--n-slice",
                           str(cfg.train.n_slice), "--device", "cuda",
                           *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(kernels.launches)
            perf = json.loads((tmp / name / "performance.json").read_text())
            losses = perf["loss_train"] + perf["loss_valid"]
            if rc != 0 or not all(map(math.isfinite, losses)):
                raise AssertionError(f"(l) train {name}: rc {rc}, losses "
                                     f"{losses}")
            per_step = dict.fromkeys(MHA_SOURCES, 0)
            if m.dropout > 0:
                per_step.update(
                    fused_mha_dropout=att * (2 if m.remat else 1),
                    fused_mha_dropout_bwd=att,
                    hash_keep_mask=act * (3 if m.remat else 2))
            else:
                per_step.update(fused_mha=att - 1, fused_mha_bwd=att - 1,
                                fused_mha_with_probs=1,
                                fused_mha_with_probs_bwd=1, hash_keep_mask=0)
            want = {k: v * steps for k, v in per_step.items()}
            if name != "remat":       # validation on the per-site path
                want["fused_mha"] += n_valid * (
                    att - (name == "return_attention"))
                want["fused_mha_with_probs"] += n_valid * (
                    name == "return_attention")
            want.update({k: 0 for k in counts if k.startswith(train_k)})
            got = {k: counts[k] for k in want}
            if got != want or steps != 6:
                raise AssertionError(f"(l) train {name}: launches {got}, "
                                     f"expected {want} ({steps} steps)")
            # the JSON line's launches: K12 from the remat training, K10
            # and K11 from the return_attention one
            main_counts.update({k: counts[k] for k in MHA_SOURCES
                                if (name == "remat") == ("dropout" in k)
                                and name in ("remat", "return_attention")})
            ckpt = tmp / name / "checkpoints" / "model_000_000" / "model.dat"
            moved = ""
            if m.enc_alg == "cnnblock_safreq":
                sd = torch.load(ckpt, weights_only=True)["model_dict"]
                rv = sd["encoder_spec2midi.conv_1.1.running_var"]
                if torch.equal(rv, torch.ones_like(rv)) or sd[
                        "encoder_spec2midi.conv_1.1.num_batches_tracked"] \
                        != steps:
                    raise AssertionError("(l) 2FDT: BatchNorm statistics "
                                         "did not move")
                moved = (f"; BatchNorm running_var of conv_1.1 now "
                         f"{rv.mean().item():.4f} (mean), {steps} batches")
            kernels.reset_launches()
            rc = cli_main(["transcribe", "--checkpoint", str(ckpt),
                           "--config", str(tmp / f"{name}.json"), "--wav",
                           str(tmp / "piece.wav"), "--out",
                           str(tmp / f"{name}_out"), "--batch-windows",
                           str(BATCH), "--device", "cuda"])
            torch.cuda.synchronize()
            t_counts = {k: v for k, v in kernels.launches.items() if v}
            notes = json.loads((tmp / f"{name}_out" / "piece.notes.json")
                               .read_text())
            per_site = name != "remat"
            if rc != 0 or (t_counts.get("fused_mha", 0) != n_batches * (
                    att - (name == "return_attention")) if per_site else
                    t_counts.get("encoder_layer_with_stem") != n_batches):
                raise AssertionError(f"(l) transcribe {name}: rc {rc}, "
                                     f"launches {t_counts}")
            log(f"(l) cli train {name} (paper bf16, dropout {m.dropout}, "
                f"{steps} steps of {cfg.train.batch_size}): {wall:.2f} s "
                f"wall, loss train {perf['loss_train'][0]:.5f}, valid "
                f"{perf['loss_valid'][0]:.5f}; launches per step "
                f"{per_step}, K7-K9 0{moved}; transcribe with its "
                f"checkpoint: {len(notes)} notes, launches {t_counts}")
    return main_counts, first

# (m) head_dim 32: the default configuration -------------------------------

def check_default_config(feat, audio, spec, dev, card, cli_main) -> None:
    """(m): the default ``ModelConfig()`` (hid 64, 2 + 2 heads, so head_dim
    32; pf 128, dropout 0.1) in bf16 on the card: (m.1) the D = 32
    attention kernels at the four site geometries under (l)'s gates; (m.2)
    K2-K5 at batch 32 under (c)'s gates and K7-K9 forward and backward at
    batch 8 under (h)'s, with the chained input grads bounded by the plain
    twin's own distance from the f32 truth (widths that are not multiples
    of 128 take the partial tiles of the weight-gradient kernel); (m.3) the engine's
    batch-32 forward against the plain bf16 forward under (e)'s gates;
    (m.4) ``cli train`` (3 steps of 16, the fused trainer), ``cli
    transcribe --list`` with its checkpoint and ``cli evaluate``, each with
    its launch counts."""
    from nylon_amt_tpu_torch import Config, ModelConfig, TrainConfig, kernels
    from nylon_amt_tpu_torch.data.lists import CorpusList
    from nylon_amt_tpu_torch.infer import engine
    from nylon_amt_tpu_torch.midi.smf import write_notes
    from nylon_amt_tpu_torch.models.hft import HFT
    from nylon_amt_tpu_torch.models.init import reference_initialize
    from nylon_amt_tpu_torch.ops import layer_fused as lf
    from nylon_amt_tpu_torch.ops.precision import full_f32
    from nylon_amt_tpu_torch.utils.wavio import save_wav

    m = ModelConfig(compute_dtype="bfloat16")
    cfg = Config(model=m, train=TrainConfig(batch_size=16))
    heads = m.enc_head
    if m.hid_dim // heads != 32 or m.dec_head != heads:
        raise AssertionError(f"the default model is not head_dim 32: {m}")

    # (m.1) the D = 32 kernels
    check_attention_kernels(dev, heads=heads, hid=m.hid_dim, phase="m")

    # (m.2) the layer kernels at the default widths
    gen = torch.Generator().manual_seed(SEED + 7)
    model = reference_initialize(HFT(cfg, dev), gen).eval()
    model32 = HFT(dataclasses.replace(cfg, model=dataclasses.replace(
        m, compute_dtype="float32")), dev)
    model32.load_state_dict(model.state_dict())
    model32.eval()
    packed = engine.pack_params(model, torch.bfloat16)
    check_layers(cfg, packed, engine.pack_params(model32, torch.float32),
                 spec, dev, phase="m")
    check_train_layers(model, cfg, dev, {
        "enc": lf.encoder_layer, "dec_zero": lf.decoder_layer_zero,
        "dec": lf.decoder_layer}, phase="m", chain_ulps=None)
    torch.cuda.empty_cache()

    # (m.3) the engine's forward against the plain one
    torch.cuda.synchronize()
    kernels.reset_launches()
    got = engine.forward(packed, spec, cfg)
    torch.cuda.synchronize()
    f_counts = {k: v for k, v in kernels.launches.items() if v}
    want = {"encoder_layer_with_stem": 1,
            "encoder_layer": m.enc_layer - 1 + m.dec_layer,
            "decoder_layer_zero": 1, "decoder_layer": m.dec_layer - 1}
    if f_counts != want:
        raise AssertionError(f"(m) engine forward launches {f_counts}, "
                             f"expected {want}")
    with torch.no_grad():
        plain16 = model(spec)
        with full_f32():
            truth = model32(spec)
    failed, line = [], []
    for k in truth:
        try:
            e_k, e_p = bf16_gate(f"(m) engine {k}", got[k], plain16[k],
                                 truth[k])
        except AssertionError as e:
            failed.append(str(e))
            e_k = e_p = float("nan")
        _, ulps = ulp_distance(got[k], plain16[k])
        if not ulps <= ULPS_FORWARD[k[-1]]:
            failed.append(f"(m) engine {k}: {ulps:.1f} ulps from plain bf16 "
                          f"> {ULPS_FORWARD[k[-1]]}")
        line.append(f"{k} {ulps:.1f} ulps (gate {e_k:.4f}/{e_p:.4f})")
    if failed:
        raise AssertionError("; ".join(failed))
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: engine.forward(packed, spec, cfg), iters=10)
        plain_ms = cuda_ms(lambda: model(spec), iters=3)
    audio_s = BATCH * cfg.input.num_frame * cfg.feature.hop_sample / SR
    log(f"(m) batch-{BATCH} default-config bf16 forward (hid {m.hid_dim}, "
        f"{heads} heads of 32): engine vs plain bf16 (<= 8 / 64 ulps): "
        + ", ".join(line) + f"; engine {fwd_ms:.3f} ms ({audio_s / fwd_ms * 1e3:.1f} "
        f"audio-s/s), plain {plain_ms:.3f} ms; launches {f_counts}; card "
        f"{card}")
    profile_forward(lambda: engine.forward(packed, spec, cfg), iters=5,
                    phase="m", top=6)
    del model32, truth, plain16, got

    # (m.4) train, transcribe and evaluate through the CLI
    n_frames = 1 + int(AUDIO_SEC * SR) // cfg.feature.hop_sample
    n_batches = math.ceil(math.ceil(n_frames / cfg.input.num_frame) / BATCH)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        cfg.save(str(tmp / "config.json"))
        write_corpus(cfg, feat, tmp / "corpus")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = cli_main(["train", "--config", str(tmp / "config.json"),
                       "--dataset", str(tmp / "corpus"), "--out",
                       str(tmp / "run"), "--epochs", "1", "--n-slice",
                       str(cfg.train.n_slice), "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.launches)
        perf = json.loads((tmp / "run" / "performance.json").read_text())
        losses = perf["loss_train"] + perf["loss_valid"]
        if rc != 0 or not all(map(math.isfinite, losses)):
            raise AssertionError(f"(m) train: rc {rc}, losses {losses}")
        steps = 3                       # 48 train windows, batch 16
        per_step = {"hash_keep_mask": 4,
                    "encoder_layer_train": m.enc_layer + m.dec_layer,
                    "encoder_layer_train_bwd": m.enc_layer + m.dec_layer,
                    "decoder_layer_zero_train": 1,
                    "decoder_layer_zero_train_bwd": 1,
                    "decoder_layer_train": m.dec_layer - 1,
                    "decoder_layer_train_bwd": m.dec_layer - 1}
        want = {k: v * steps for k, v in per_step.items()}
        want.update(dict.fromkeys(MHA_SOURCES, 0))   # no per-site path
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"(m) train launches {got}, expected {want}")
        ckpt = tmp / "run" / "checkpoints" / "model_000_000" / "model.dat"
        save_wav(str(tmp / "piece.wav"), audio, SR)
        write_notes(str(tmp / "piece.mid"), synth_notes(AUDIO_SEC))
        cl = CorpusList()
        cl.add("test", "piece", str(tmp / "piece.wav"), str(tmp / "piece.mid"))
        cl.save(str(tmp / "lists"))
        torch.cuda.synchronize()
        kernels.reset_launches()
        rc = cli_main(["transcribe", "--checkpoint", str(ckpt), "--config",
                       str(tmp / "config.json"), "--list", str(tmp / "lists"),
                       "--split", "test", "--out", str(tmp / "out"),
                       "--batch-windows", str(BATCH), "--device", "cuda"])
        torch.cuda.synchronize()
        t_counts = {k: v for k, v in kernels.launches.items() if v}
        t_want = {"log_mel": 1, "encoder_layer_with_stem": n_batches,
                  "encoder_layer": n_batches * (m.enc_layer - 1
                                                + m.dec_layer),
                  "decoder_layer_zero": n_batches,
                  "decoder_layer": n_batches * (m.dec_layer - 1)}
        if rc != 0 or t_counts != t_want:
            raise AssertionError(f"(m) transcribe: rc {rc}, launches "
                                 f"{t_counts}, expected {t_want}")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_main(["evaluate", "--config", str(tmp / "config.json"),
                           "--list", str(tmp / "lists"), "--split", "test",
                           "--est-dir", str(tmp / "out"), "--out",
                           str(tmp / "scores.json")])
        res = json.loads((tmp / "scores.json").read_text())
        if rc != 0 or "piece.notes.json" not in res["note"]["per_file"]:
            raise AssertionError(f"(m) evaluate: rc {rc}, {res}")
        notes = json.loads((tmp / "out" / "piece.notes.json").read_text())
    f_note = res["note"]["mean"].get("F-measure", float("nan"))
    log(f"(m) cli train, default config bf16 (dropout {m.dropout}), "
        f"{steps} steps of {cfg.train.batch_size}: {wall:.2f} s wall, loss "
        f"train {perf['loss_train'][0]:.5f}, valid "
        f"{perf['loss_valid'][0]:.5f}; launches per step {per_step}, "
        f"per-site K10-K12 0; transcribe --list with its checkpoint: "
        f"{len(notes)} notes, launches {t_counts}; evaluate: note F "
        f"{f_note:.4f} (3 steps from random weights)")


# (n) the default Config() in float32 -------------------------------------

# f32 kernel outputs against the plain f32 version (under full_f32): the
# same IEEE products, f32 sums in another order; of max(1, max |plain|)
F32_OUT_REL = 2e-5
# f32 input and weight gradients: of max |plain|
F32_GRAD_REL = 1e-4
# each f32 backward kernel fed the plain twin's own intermediates (the stage
# hook): of max |the twin's same stage|
F32_STAGE_REL = 1e-5
# The chained f32 backward meets one discontinuity, the FFN's ReLU gate: an
# element whose pre-activation the kernel's forward recompute and the twin
# put on opposite sides of 0 (both within F32_OUT_REL of 0) passes its
# whole gradient in one and none in the other, and the attention backward
# spreads that over its sequence. So the chained input grads are held on
# the sequences with no such flip, and every flip must sit within
# F32_OUT_REL x max(1, max |u|) of 0; weight grads (sums over every row)
# are held end to end when nothing flipped, and by the stage hook always.
# K11's f32 probabilities, absolute (p / l <= 1)
F32_PROBS_ATOL = 1e-6
# the f32 engine forward against the plain f32 forward, of max(1, max
# |plain|): stage 1 (A heads) as a layer; stage 2 (B heads) runs three more
# layers on stage 1's output, as in (e) (PERF.md section 2)
F32_FORWARD_REL = {"A": 2e-5, "B": 2e-4}
# K13 in f32. Kernel by kernel, each on the plain version's own codes and
# intermediates: the s8 GEMMs' dequantised outputs bit for bit, the
# residual + LayerNorm epilogue within F32_OUT_REL (its output codes the
# plain quantizer's on its own output, bit for bit), the int8 attention
# with >= Q8_SHARE of the elements within Q8_F32_REL x max |plain| and all
# within Q8_BUDGET. A whole f32 layer cannot be held that tightly: f32
# hides no reordering (of l, of the LN sums) behind a bf16 rounding, so
# each reaches the next quantizer, and a code flipped there moves its row
# by ~1/127 of the row's scale (the stem layer read 98.2% of its elements
# within 1e-5 of max |plain q8|, all within 0.039: PERF.md section 2). So
# each wrapper is held by (k)'s gates: >= Q8_SHARE within 4 bf16 ulps of
# max |plain q8|, all within Q8_BUDGET, and no further from the exact f32
# layer than the plain q8 version + Q8_F32_EXACT.
Q8_F32_REL = 1e-5
Q8_F32_EXACT = 1e-4

def f32_mm_ms(gemms, dev) -> float:
    """Time of f32 ``torch.matmul`` (IEEE f32: no TF32) on a layer's GEMM
    shapes ``[(M, K, N), ...]``, one call each: the library yardstick of
    the f32 layer kernels (the port never calls it)."""
    from nylon_amt_tpu_torch.ops.precision import full_f32

    g = torch.Generator(device=dev).manual_seed(3)
    ops = [(torch.randn((m, k), generator=g, device=dev),
            torch.randn((k, n), generator=g, device=dev)) for m, k, n in gemms]
    with full_f32():
        return cuda_ms(lambda: [a @ b for a, b in ops], iters=3)


def layer_gemms(kind: str, n: int, lq: int, lk: int, hid: int,
                pf: int) -> list:
    """The (M, K, N) of a layer forward's projections."""
    gemms = [(n * lq, hid, hid), (n * lq, hid, pf), (n * lq, pf, hid)]
    gemms += ([(n * lq, hid, 3 * hid)] if kind == "enc" else
              [(n * lq, hid, hid), (n * lk, hid, 2 * hid)])
    if kind == "dec":
        gemms += [(n * lq, hid, 3 * hid), (n * lq, hid, hid)]
    return gemms


def check_attention_f32(dev, heads: int, hid: int) -> dict:
    """(n.1): K10, K11 and K12 in f32 forward and backward against their
    plain f32 versions at the four site geometries, batch 8: outputs within
    F32_OUT_REL, input gradients within F32_GRAD_REL, K11's probabilities
    within F32_PROBS_ATOL and its rows summing to 1, its output K10's bit
    for bit, K12's realized masks bit for bit, bit-identical backward runs;
    times at the row shapes of (l) beside f32 SDPA. Returns the times."""
    import torch.nn.functional as F

    from nylon_amt_tpu_torch.ops import attention as att
    from nylon_amt_tpu_torch.ops.precision import full_f32

    scale, d = 0.125, hid // heads
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    mask = lambda h, shape: att.hash_keep_mask_plain(   # noqa: E731
        DROP_SEED, h, 0, shape, RATE, torch.float32, dev)
    fns = {"fused_mha": (lambda q, k, v: att.fused_mha(q, k, v, heads, scale),
                         None),
           "fused_mha_dropout": (lambda q, k, v: att.fused_mha_dropout(
               q, k, v, heads, scale, RATE, DROP_SEED), mask)}
    line = []
    for site, (lq, lk, per) in ATTN_SITES.items():
        n = TRAIN_BATCH * per
        q, k, v, do = (torch.randn((n, L, hid), generator=g, device=dev)
                       for L in (lq, lk, lk, lq))
        worst = [0.0, 0.0]

        def grads(fn):
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            out = fn(qq, kk, vv)
            out = out[0] if isinstance(out, tuple) else out
            return torch.autograd.grad(out, (qq, kk, vv), do)

        for name, (fn, msk) in fns.items():
            got = fn(q, k, v)
            with full_f32():
                want = att.mha_plain(q, k, v, heads, scale, msk)
                pb = att.mha_bwd_plain(q, k, v, do, heads, scale, msk)
            e = rel_err(got, want, 1.0)
            kb, kb2 = grads(fn), grads(fn)
            if not all(torch.equal(a, b) for a, b in zip(kb, kb2)):
                raise AssertionError(f"(n) f32 {name} bwd {site}: two runs "
                                     f"differ")
            eg = max(rel_err(a, b) for a, b in zip(kb, pb))
            if not (e <= F32_OUT_REL and eg <= F32_GRAD_REL):
                raise AssertionError(
                    f"(n) f32 {name} {site} D{d}: output {e:.2e} (<= "
                    f"{F32_OUT_REL}), input grads {eg:.2e} (<= "
                    f"{F32_GRAD_REL}) from the plain f32 version")
            worst = [max(worst[0], e), max(worst[1], eg)]
            for n_ in (name, name + "_bwd"):
                held(n_, torch.float32, d)
            if name == "fused_mha":
                k10, k10b = got, kb
            del got, want, kb, kb2, pb
        o11, probs = att.fused_mha_with_probs(q, k, v, heads, scale)
        with full_f32():
            _, p_plain = att.mha_plain(q, k, v, heads, scale, with_probs=True)
        p_err = (probs - p_plain).abs().max().item()
        r_err = (probs.sum(-1) - 1.0).abs().max().item()
        k11b = grads(lambda a, b, c: att.fused_mha_with_probs(
            a, b, c, heads, scale))
        if not (torch.equal(o11, k10) and p_err <= F32_PROBS_ATOL
                and r_err <= ROW_SUM_ATOL
                and all(torch.equal(a, b) for a, b in zip(k11b, k10b))):
            raise AssertionError(
                f"(n) f32 fused_mha_with_probs {site} D{d}: output equal to "
                f"K10's {torch.equal(o11, k10)}, probs {p_err:.2e} (<= "
                f"{F32_PROBS_ATOL}), rows 1 +- {r_err:.2e} (<= "
                f"{ROW_SUM_ATOL})")
        held("fused_mha_with_probs", torch.float32, d)
        held("fused_mha_with_probs_bwd", torch.float32, d)
        keeps = _realized_masks(att, n, lq, lk, heads, d, dev, torch.float32)
        for h in range(heads):
            if not torch.equal(keeps[h], mask(h, (n, lq, lk)) != 0):
                raise AssertionError(f"(n) f32 K12 {site} D{d}: head {h}'s "
                                     f"mask differs from the plain one")
        line.append(f"{site} [{n}, {lq}, {lk}]: out {worst[0]:.2e}, grads "
                    f"{worst[1]:.2e}, K11 probs {p_err:.2e} rows "
                    f"{r_err:.2e}, K12 masks bit-identical")
        del q, k, v, do, k10, k10b, o11, probs, p_plain, k11b, keeps
        torch.cuda.empty_cache()
    from nylon_amt_tpu_torch import kernels
    occ = kernels.load().nylon_attention_f32_occupancy
    log(f"(n.1) f32 attention blocks per SM at D{d} (forward / backward): "
        + ", ".join(f"{site} {occ(d, lq, lk, 0)} / {occ(d, lq, lk, 1)}"
                    for site, (lq, lk, _) in ATTN_SITES.items()))
    log(f"(n.1) f32 K10/K11/K12, {heads} heads of {d}, batch "
        f"{TRAIN_BATCH} (of max(1, |plain|) / of max |plain|): "
        + "; ".join(line) + "; backward runs bit-identical")
    # times at (l)'s row shapes, beside f32 SDPA on the same inputs
    times = {}
    for name, (B, site) in MHA_ROW_SHAPES.items():
        lq, lk, per = ATTN_SITES[site]
        n = B * per
        q, k, v, do = (torch.randn((n, L, hid), generator=g, device=dev)
                       for L in (lq, lk, lk, lq))
        msk = mask if "dropout" in name else None
        rate = RATE if msk else 0.0
        base = name.removesuffix("_bwd")
        fn = (lambda a, b, c: att.fused_mha_with_probs(a, b, c, heads, scale)
              ) if base == "fused_mha_with_probs" else fns[base][0]

        def sd(a, b, c, rate=rate):
            return F.scaled_dot_product_attention(
                *(t.view(n, -1, heads, d).transpose(1, 2) for t in (a, b, c)),
                dropout_p=rate).transpose(1, 2).reshape(n, lq, hid)

        with full_f32():
            if name.endswith("_bwd"):
                ms = _bwd_only_ms(fn, q, k, v, do)
                lib = _bwd_only_ms(sd, q, k, v, do)
                plain_ms = cuda_ms(lambda: att.mha_bwd_plain(
                    q, k, v, do, heads, scale, msk), iters=1)
                nb, products = nbytes(q, k, v, do, q, k, v), 5
            else:
                ms = cuda_ms(lambda: fn(q, k, v))
                lib = (None if base == "fused_mha_with_probs"
                       else cuda_ms(lambda: sd(q, k, v)))
                plain_ms = cuda_ms(lambda: att.mha_plain(
                    q, k, v, heads, scale, msk,
                    with_probs=base == "fused_mha_with_probs"), iters=1)
                nb, products = nbytes(q, k, v, q), 2
                if base == "fused_mha_with_probs":
                    nb += n * heads * lq * lk * 4
        flops = 2 * products * n * heads * lq * lk * d
        hash_ops = 8 * n * heads * lq * lk if msk else 0
        # as the products run (the forward's scores on FFMA, its PV and
        # every backward product as 3xTF32), all as 3xTF32, all on FFMA
        ffma = bound(nb, f32_flops=flops + hash_ops)
        tf32 = bound(nb, f32_flops=hash_ops, tf32x3_flops=flops)
        run = tf32 if name.endswith("_bwd") else bound(
            nb, f32_flops=flops / 2 + hash_ops, tf32x3_flops=flops / 2)
        times[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib,
                           shape=[n, lq, lk], **run)
        log(f"(n.1) f32 {name} [{n}, {lq}, {lk}] D{d}: kernel {ms:.3f} ms "
            f"(FFMA kernel {FFMA_F32_MS[name, d]:.3f}), plain "
            f"{plain_ms:.3f} ms, SDPA f32 "
            + ("-" if lib is None else f"{lib:.3f}")
            + f" ms, bound as run {run['bound_ms']:.3f} ms "
            f"({run['bound_by']}), all 3xTF32 {tf32['bound_ms']:.3f} ms "
            f"({tf32['bound_by']}), all FFMA {ffma['bound_ms']:.3f} ms "
            f"({ffma['bound_by']})")
        del q, k, v, do
        torch.cuda.empty_cache()
    return times


def check_layers_f32(cfg, packed, spec, dev, names, tag: str) -> dict:
    """(n.2): K2-K5 in f32 at the batch-32 shapes of ``cfg`` (K2 on the
    real windows ``spec``) against their plain f32 versions, within
    F32_OUT_REL; times beside the plain version, an f32 ``torch.matmul``
    of the layer's GEMMs and the bound. Returns the times."""
    from nylon_amt_tpu_torch.ops import layer_fused as lf
    from nylon_amt_tpu_torch.ops.precision import full_f32

    m = cfg.model
    hid, pf, n_frame = m.hid_dim, m.pf_dim, cfg.input.num_frame
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    n_f, n_t = BATCH * n_frame, BATCH * 88
    n_proc = packed.k_eff.shape[0]

    def act(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def stem(fn):
        return lambda s, p, heads: fn(s, packed.k_eff, packed.b_eff,
                                      packed.pos_freq, p, heads, n_frame,
                                      torch.float32)

    spec_t = spec.transpose(1, 2).contiguous()
    checks = {  # kernel, plain, inputs, params, heads, (kind, n, lq, lk)
        "encoder_layer_with_stem": (
            stem(lf.encoder_layer_with_stem),
            stem(lf.encoder_layer_with_stem_plain), lambda: (spec_t,),
            packed.enc[0], m.enc_head, ("enc", n_f, 256, 256)),
        "encoder_layer": (lf.encoder_layer, lf.encoder_layer_plain,
                          lambda: (act(n_f, 256, hid),), packed.enc[1],
                          m.enc_head, ("enc", n_f, 256, 256)),
        "encoder_layer/time": (lf.encoder_layer, lf.encoder_layer_plain,
                               lambda: (act(n_t, n_frame, hid),),
                               packed.time[0], m.dec_head,
                               ("enc", n_t, n_frame, n_frame)),
        "decoder_layer_zero": (lf.decoder_layer_zero,
                               lf.decoder_layer_zero_plain,
                               lambda: (act(n_f, 88, hid),
                                        act(n_f, 256, hid)),
                               packed.dec_zero, m.dec_head,
                               ("dec_zero", n_f, 88, 256)),
        "decoder_layer": (lf.decoder_layer, lf.decoder_layer_plain,
                          lambda: (act(n_f, 88, hid), act(n_f, 256, hid)),
                          packed.dec[0], m.dec_head, ("dec", n_f, 88, 256))}
    results = {}
    for name in names:
        fn, plain, make, p, heads, (kind, n, lq, lk) = checks[name]
        xs = make()
        got = fn(*xs, p, heads)
        with full_f32():
            want = plain(*xs, p, heads)
        e = rel_err(got, want, 1.0)
        if not (got.dtype == torch.float32 and e <= F32_OUT_REL):
            raise AssertionError(f"(n) f32 {name} {tag}: {got.dtype}, "
                                 f"{e:.2e} of max(1, |plain f32|) > "
                                 f"{F32_OUT_REL}")
        held(name, torch.float32, hid // heads)
        del want
        ms = cuda_ms(lambda: fn(*xs, p, heads))
        with full_f32():
            plain_ms = cuda_ms(lambda: plain(*xs, p, heads), iters=2)
        stem_flops = 2 * n * 256 * n_proc * hid if "stem" in name else 0
        weights = [t for t in p if t.numel()]
        if stem_flops:
            weights += [packed.k_eff, packed.b_eff, packed.pos_freq]
        flops = layer_flops(kind, n, lq, lk, hid, pf) + stem_flops
        pv = attn_product_flops(kind, n, lq, lk, hid)  # 3xTF32
        lib = f32_mm_ms(layer_gemms(kind, n, lq, lk, hid, pf), dev)
        results[name] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms,
                             library_ms=lib, shape=[n, lq, lk, hid],
                             **bound(nbytes(*xs, *weights, got),
                                     f32_flops=flops - pv, tf32x3_flops=pv))
        log(f"(n.2) f32 {name} {tag} at {[tuple(x.shape) for x in xs]}: "
            f"{e:.2e} of max(1, |plain f32|) (<= {F32_OUT_REL}); kernel "
            f"{ms:.3f} ms, plain f32 {plain_ms:.3f} ms, f32 matmul of its "
            f"GEMMs {lib:.3f} ms, bound {results[name]['bound_ms']:.3f} ms "
            f"({results[name]['bound_by']})")
        del xs, got
        torch.cuda.empty_cache()
    return results


def check_train_layers_f32(model, cfg, dev, names, tag: str) -> dict:
    """(n.2): K7, K8, K9 in f32 forward and backward at the batch-8 shapes
    of ``cfg`` against their plain f32 twins: the forward within
    F32_OUT_REL, input and weight gradients within F32_GRAD_REL,
    bit-identical backward runs, and (h)'s stage hook: every backward
    kernel fed the twin's own intermediates within F32_STAGE_REL of the
    twin's same stage, its weight gradients within STAGE_WGRAD_REL. Returns
    the times."""
    m = cfg.model
    hid, pf = m.hid_dim, m.pf_dim
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    layers = _train_layers(model, dev, torch.float32)
    results = {}
    for name in names:
        kind, xs, p, emb = layers[name]
        heads = m.enc_head if kind == "enc" else m.dec_head
        k_fwd, p_fwd, k_bwd, p_bwd = _layer_fns(kind, emb, heads)
        n, lq, _ = xs[0].shape
        lk = xs[-1].shape[1]
        got = k_fwd(xs, p, RATE)
        want = p_fwd(xs, p, RATE)
        e = rel_err(got, want, 1.0)
        dz = torch.randn(xs[0].shape, generator=g, device=dev)
        own = {}   # the kernels' own FFN activations, by a pass-through hook

        def record(stage, t):
            if stage.endswith("midd"):
                own[stage] = t
            return t

        kb, kb2 = k_bwd(xs, p, RATE, dz, record), k_bwd(xs, p, RATE, dz)
        k_in, k_w = _split_bwd(kind, kb)
        k_in2, k_w2 = _split_bwd(kind, kb2)
        if not all(torch.equal(a, b) for a, b in zip(list(k_w) + k_in,
                                                     list(k_w2) + k_in2)):
            raise AssertionError(f"(n) f32 {name} bwd: two runs differ")
        del kb2, k_in2, k_w2
        taps = {}
        p_in, p_w = _split_bwd(kind, p_bwd(xs, p, RATE, dz, taps))
        # ReLU gates the kernels' recompute and the twin set differently
        pre = "" if kind == "enc" else "cross."
        mine = own[pre + "midd"]
        flips = (mine > 0) != (taps[pre + "midd"].reshape(mine.shape) > 0)
        u = taps[pre + "u"].reshape(mine.shape)
        n_flips = int(flips.sum().item())
        near = u[flips].abs().max().item() if n_flips else 0.0
        near_limit = F32_OUT_REL * max(1.0, u.abs().max().item())
        clean = ~flips.any(-1).reshape(n, -1).any(-1)  # sequences
        if not clean.any():
            raise AssertionError(f"(n) f32 {name}: a ReLU gate flipped in "
                                 f"every sequence")
        e_in = max((a[clean] - b[clean]).abs().max().item()
                   / b.abs().max().item() for a, b in zip(k_in, p_in))
        e_w = max(rel_err(a, b) for a, b in zip(k_w, p_w))
        if not (e <= F32_OUT_REL and e_in <= F32_GRAD_REL
                and near <= near_limit
                and (n_flips > 0 or e_w <= F32_GRAD_REL)):
            raise AssertionError(
                f"(n) f32 {name} {tag}: fwd {e:.2e} (<= {F32_OUT_REL}), "
                f"input grads {e_in:.2e} on the {int(clean.sum())} of {n} "
                f"sequences with no ReLU gate flip, weight grads {e_w:.2e} "
                f"(<= {F32_GRAD_REL} when nothing flipped) from the plain "
                f"f32 twin; {n_flips} flips, within {near:.2e} of 0 (<= "
                f"{near_limit:.2e})")
        del own, mine, flips, u
        seen = {}

        def hook(stage, t):
            want_ = taps[stage].reshape(t.shape).contiguous()
            if want_.dtype != t.dtype:
                raise AssertionError(f"(n) {name} stage {stage}: the twin's "
                                     f"{want_.dtype} for {t.dtype}")
            seen[stage] = (t, want_)
            return want_

        _, s_w = _split_bwd(kind, k_bwd(xs, p, RATE, dz, hook))
        torch.cuda.synchronize()
        if len(seen) != STAGES[kind]:
            raise AssertionError(f"(n) f32 {name} bwd: the stage hook saw "
                                 f"{sorted(seen)}, {STAGES[kind]} expected")
        stage = {k: rel_err(a, b) for k, (a, b) in seen.items()}
        worst = max(stage, key=stage.get)
        sw = max(rel_err(a, b) for a, b in zip(s_w, p_w))
        if not (stage[worst] <= F32_STAGE_REL and sw <= STAGE_WGRAD_REL):
            raise AssertionError(
                f"(n) f32 {name} bwd on the twin's inputs: stage {worst} "
                f"{stage[worst]:.2e} (<= {F32_STAGE_REL}), weight grads "
                f"{sw:.2e} (<= {STAGE_WGRAD_REL})")
        held(name, torch.float32, hid // heads)
        held(bwd_name(name), torch.float32, hid // heads)
        del seen, s_w, taps, p_in, p_w, want
        fwd_ms = cuda_ms(lambda: k_fwd(xs, p, RATE))
        fwd_plain_ms = cuda_ms(lambda: p_fwd(xs, p, RATE), iters=2)
        bwd_ms = cuda_ms(lambda: k_bwd(xs, p, RATE, dz), iters=3)
        bwd_plain_ms = cuda_ms(lambda: p_bwd(xs, p, RATE, dz), iters=1)
        flops = layer_flops(kind, n, lq, lk, hid, pf)
        # a = one attention product: the forward's scores on FFMA, its PV
        # as 3xTF32; the backward recomputes the forward (GEMMs, scores,
        # PV) and adds the GEMMs' dX and dW and 5 attention products
        a = attn_product_flops(kind, n, lq, lk, hid)
        w_bytes, io_bytes = nbytes(*p), nbytes(*xs)
        gemms = layer_gemms(kind, n, lq, lk, hid, pf)
        results[name] = dict(
            max_abs_err=e, ms=fwd_ms, plain_ms=fwd_plain_ms,
            library_ms=f32_mm_ms(gemms, dev), shape=[n, lq, lk, hid],
            **bound(io_bytes + w_bytes + nbytes(got), f32_flops=flops - a,
                    tf32x3_flops=a))
        results[bwd_name(name)] = dict(
            max_abs_err=e_in, ms=bwd_ms, plain_ms=bwd_plain_ms,
            library_ms=f32_mm_ms(gemms * 3, dev), shape=[n, lq, lk, hid],
            **bound(2 * io_bytes + nbytes(dz) + 2 * w_bytes,
                    f32_flops=3 * (flops - 2 * a) + a, tf32x3_flops=6 * a))
        log(f"(n.2) f32 {name} {tag} at {[tuple(x.shape) for x in xs]}, rate "
            f"{RATE}: fwd {e:.2e}, input grads {e_in:.2e} ({n_flips} ReLU "
            f"gates flipped, within {near:.2e} of 0; {int(clean.sum())} of "
            f"{n} sequences held), weight grads {e_w:.2e} from the plain f32 "
            f"twin; {len(stage)} stages on the "
            f"twin's inputs <= {stage[worst]:.2e} ({worst}), their weight "
            f"grads <= {sw:.2e}; bit-identical runs; fwd kernel "
            f"{fwd_ms:.3f} ms (plain {fwd_plain_ms:.3f}, f32 matmul "
            f"{results[name]['library_ms']:.3f}, bound "
            f"{results[name]['bound_ms']:.3f}), bwd kernel {bwd_ms:.3f} ms "
            f"(plain {bwd_plain_ms:.3f}, bound "
            f"{results[bwd_name(name)]['bound_ms']:.3f})")
        del xs, got, kb, k_in, k_w, dz
        torch.cuda.empty_cache()
    return results


def check_int8_d32(model16, model32, cfg, spec, dev, tag: str = "") -> dict:
    """(n.3): K13 at head_dim 32 (the default widths), in bf16 and in f32:
    the quantizers bit for bit; each wrapper at the batch-32 shapes against
    its plain q8 version and the exact layer, under (k)'s gates (bf16) or
    their f32 analogue (Q8_F32_REL, Q8_F32_EXACT). ``model16`` None: f32
    only (the paper widths, head_dim 64; ``tag`` "/paper" on the keys).
    Returns the f32 and bf16 times."""
    from nylon_amt_tpu_torch.infer import engine
    from nylon_amt_tpu_torch.ops import layer_fused as lf
    from nylon_amt_tpu_torch.ops import layer_fused_q8 as lq
    from nylon_amt_tpu_torch.ops.precision import full_f32

    m = cfg.model
    hid, pf, n_frame = m.hid_dim, m.pf_dim, cfg.input.num_frame
    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    n_f, n_t = BATCH * n_frame, BATCH * 88
    spec_t = spec.transpose(1, 2).contiguous()
    results = {}
    for dt, model in ((torch.bfloat16, model16), (torch.float32, model32)):
        if model is None:
            continue
        packed = engine.pack_params(model, dt)
        packed8 = engine.pack_params(model, dt, precision="int8")
        label = "bf16" if dt == torch.bfloat16 else "f32"

        def act(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dt)

        x = act(n_f * 256, 3 * hid)
        for t, n_seg in ((x[:, :hid], 1), (x[:, :2 * hid], 2),
                         (x[:, :pf], 1)):
            q, s = lq.quant_rows_cuda(t, n_seg)
            for j, seg in enumerate(t.split(t.shape[1] // n_seg, dim=1)):
                pq, ps = lq._quant_rows(seg)
                w = seg.shape[1]
                if not (torch.equal(q[:, j * w:(j + 1) * w], pq)
                        and torch.equal(s[j], ps[:, 0])):
                    raise AssertionError(f"(n) {label} row quantizer at "
                                         f"width {w} differs")
        v = x[:, 2 * hid:]
        vt, sv = lq.quant_cols_cuda(v, n_f)
        pv, psv = lq._quant_cols(v.reshape(n_f, 256, hid))
        if not (torch.equal(vt.transpose(1, 2), pv)
                and torch.equal(sv, psv[:, 0])):
            raise AssertionError(f"(n) {label} column quantizer differs")
        del x, v, q, s, vt, sv, pv, psv

        def stem(fn, dt=dt, packed=packed):
            return lambda s_, p, heads: fn(s_, packed.k_eff, packed.b_eff,
                                           packed.pos_freq, p, heads,
                                           n_frame, dt)

        checks = {  # kernel, plain q8, exact kernel, inputs, p8, p, kind
            "encoder_layer_with_stem_q8": (
                stem(lq.encoder_layer_with_stem_q8),
                stem(lq.encoder_layer_with_stem_q8_plain),
                stem(lf.encoder_layer_with_stem), (spec_t,), packed8.enc[0],
                packed.enc[0], m.enc_head, ("enc", n_f, 256, 256)),
            "encoder_layer_q8": (
                lq.encoder_layer_q8, lq.encoder_layer_q8_plain,
                lf.encoder_layer, (act(n_f, 256, hid),), packed8.enc[1],
                packed.enc[1], m.enc_head, ("enc", n_f, 256, 256)),
            "encoder_layer_q8/time": (
                lq.encoder_layer_q8, lq.encoder_layer_q8_plain,
                lf.encoder_layer, (act(n_t, n_frame, hid),),
                packed8.time[0], packed.time[0], m.dec_head,
                ("enc", n_t, n_frame, n_frame)),
            "decoder_layer_zero_q8": (
                lq.decoder_layer_zero_q8, lq.decoder_layer_zero_q8_plain,
                lf.decoder_layer_zero, (act(n_f, 88, hid),
                                        act(n_f, 256, hid)),
                packed8.dec_zero, packed.dec_zero, m.dec_head,
                ("dec_zero", n_f, 88, 256)),
            "decoder_layer_q8": (
                lq.decoder_layer_q8, lq.decoder_layer_q8_plain,
                lf.decoder_layer, (act(n_f, 88, hid), act(n_f, 256, hid)),
                packed8.dec[0], packed.dec[0], m.dec_head,
                ("dec", n_f, 88, 256))}
        line = []
        for name, (fn, plain, exact, xs, p8, p, heads, shp) in checks.items():
            got = fn(*xs, p8, heads)
            with full_f32():
                want = plain(*xs, p8, heads)
            ref = exact(*xs, p, heads)
            torch.cuda.synchronize()
            if got.dtype != dt or not torch.isfinite(got.float()).all():
                raise AssertionError(f"(n) {label} {name}: {got.dtype}, or "
                                     f"not finite")
            d = (got.float() - want.float()).abs()
            tol = ULPS * bf16_ulp(want)
            extra = (ULPS * bf16_ulp(ref) if dt == torch.bfloat16
                     else Q8_F32_EXACT)
            share = (d <= tol).float().mean().item()
            # the f32 reading at Q8_F32_REL (logged, see Q8_F32_REL)
            tight = (d <= Q8_F32_REL * want.float().abs().max().item()
                     ).float().mean().item()
            err = d.max().item()
            from_exact = (got.float() - ref.float()).abs().max().item()
            plain_exact = (want.float() - ref.float()).abs().max().item()
            if not (share >= Q8_SHARE and err <= Q8_BUDGET
                    and from_exact <= plain_exact + extra):
                raise AssertionError(
                    f"(n) {label} {name} D{hid // heads}: {share:.6f} within "
                    f"{tol:.2e} of the plain q8 version (>= {Q8_SHARE}), max "
                    f"{err:.4f} (<= {Q8_BUDGET}); {from_exact:.4f} from the "
                    f"exact layer (<= {plain_exact:.4f} + {extra:.2e})")
            held(name, dt, hid // heads)
            del d, want, ref
            ms = cuda_ms(lambda: fn(*xs, p8, heads))
            with full_f32():
                plain_ms = cuda_ms(lambda: plain(*xs, p8, heads), iters=2)
            kind, n, lq_, lk = shp
            weights = [t for t in p8 if t.numel()]
            stem_flops = 0
            if "stem" in name:
                weights += [packed.k_eff, packed.b_eff, packed.pos_freq]
                stem_flops = 2 * n * 256 * packed.k_eff.shape[0] * hid
            results[f"{name}/{label}{tag}"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=int_mm_ms(layer_gemms(kind, n, lq_, lk, hid, pf),
                                     dev),
                shape=[n, lq_, lk, hid],
                **bound(nbytes(*xs, *weights, got), f32_flops=stem_flops,
                        int8_ops=layer_flops(kind, n, lq_, lk, hid, pf)))
            line.append(f"{name} {share:.6f} ({tight:.6f} within "
                        f"{Q8_F32_REL} of max) / max {err:.2e} / exact "
                        f"{from_exact:.4f} (plain q8 {plain_exact:.4f}); "
                        f"{ms:.3f} ms (plain q8 {plain_ms:.3f}, _int_mm "
                        f"{results[f'{name}/{label}{tag}']['library_ms']:.3f})")
            del got
        if dt == torch.float32:
            line.insert(0, check_q8_kernels_f32(packed8, hid, m.enc_head,
                                                pf, dev, g))
        log(f"(n.3) K13 {label} at head_dim {hid // m.enc_head} (quantizers "
            f"bit-identical): " + "; ".join(line))
        del packed, packed8
        torch.cuda.empty_cache()
    return results


def check_q8_kernels_f32(packed8, hid: int, heads: int, pf: int, dev,
                         g) -> str:
    """(n.3): K13's f32 kernels one by one at the batch-32 encoder shapes,
    each fed the plain version's own codes and intermediates (see
    Q8_F32_REL). Returns the log text."""
    from nylon_amt_tpu_torch.ops import layer_fused_q8 as lq
    from nylon_amt_tpu_torch.ops.layer_fused import _layer_norm, _scale
    from nylon_amt_tpu_torch.ops.precision import full_f32

    p = packed8.enc[1]
    n, L = BATCH * 128, 256
    f32 = torch.float32

    def act(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def codes(x):
        q, s = lq._quant_rows(x)
        return q, s, s.reshape(-1).contiguous()

    x = act(n * L, hid)
    xq, sx2, sx = codes(x)
    mid_in = act(n * L, pf)
    mq, sm2, sm = codes(mid_in)
    with full_f32():
        gemms = {
            "qkv": (lq._gemm_q8(xq, sx, p.wqkv, p.sqkv, p.bqkv),
                    lq._qlinear_pre(xq, sx2, p.wqkv, p.sqkv, p.bqkv, f32)),
            "ffn up + ReLU": (
                lq._gemm_q8(xq, sx, p.w1, p.s1, p.b1, relu=True),
                torch.relu(lq._qlinear_pre(xq, sx2, p.w1, p.s1, p.b1, f32)))}
        y, yq, sy = lq._gemm_q8_res_ln(mq, sm, p.w2, p.s2, p.b2, x, p.g, p.b,
                                       quant_out=True)
        y_plain = _layer_norm(
            x + lq._qlinear_pre(mq, sm2, p.w2, p.s2, p.b2, f32), p.g, p.b)
    for what, (a, b) in gemms.items():
        if not torch.equal(a, b):
            raise AssertionError(f"(n) f32 K13 s8 GEMM ({what}): "
                                 f"{rel_err(a, b):.2e} from the plain "
                                 f"version, not bit-identical")
    e_ln = rel_err(y, y_plain, 1.0)
    oq, os_ = lq._quant_rows(y)
    if not (e_ln <= F32_OUT_REL and torch.equal(yq, oq)
            and torch.equal(sy, os_.reshape(-1))):
        raise AssertionError(f"(n) f32 K13 residual + LN: {e_ln:.2e} of "
                             f"max(1, |plain|) (<= {F32_OUT_REL}); output "
                             f"codes equal to the plain quantizer's "
                             f"{torch.equal(yq, oq)}")
    del gemms, y, yq, sy, y_plain, oq, os_, mid_in, mq
    q, k, v = (act(n, L, hid) for _ in range(3))
    qq, _, sq = codes(q.reshape(-1, hid))
    kq, _, sk = codes(k.reshape(-1, hid))
    vt, sv = lq.quant_cols_cuda(v.reshape(-1, hid), n)
    got = lq._attention_q8(qq, sq, kq, sk, vt, sv, n, heads, f32)
    with full_f32():
        want = lq._mha_block_q8(q, k, v, heads, _scale(hid, heads))
    d = (got.reshape(want.shape) - want).abs()
    share = (d <= Q8_F32_REL * want.abs().max().item()).float().mean().item()
    if not (share >= Q8_SHARE and d.max().item() <= Q8_BUDGET):
        raise AssertionError(f"(n) f32 K13 attention: {share:.6f} of the "
                             f"elements within {Q8_F32_REL} of max |plain| "
                             f"(>= {Q8_SHARE}), max {d.max().item():.2e} (<= "
                             f"{Q8_BUDGET})")
    return (f"kernels on the plain version's codes at [{n * L}, {hid}]: s8 "
            f"GEMMs bit-identical, residual + LN {e_ln:.2e} with its output "
            f"codes bit-identical, attention {share:.6f} within "
            f"{Q8_F32_REL} (max {d.max().item():.2e})")


def check_forward_f32(cfg, model32, spec, dev, card, tag: str,
                      with_int8: bool) -> dict:
    """(n.4): the engine's batch-32 forward of ``cfg`` (float32) against
    the plain f32 forward, per output key, within F32_FORWARD_REL of max(1,
    max |plain|); with ``with_int8`` also the int8 forward under (k)'s
    posterior gates against the f32 forward. Returns the times."""
    from nylon_amt_tpu_torch import kernels
    from nylon_amt_tpu_torch.infer import engine
    from nylon_amt_tpu_torch.ops import layer_fused_q8 as lq
    from nylon_amt_tpu_torch.ops.precision import full_f32

    m = cfg.model
    packed = engine.pack_params(model32, torch.float32)
    torch.cuda.synchronize()
    kernels.reset_launches()
    got = engine.forward(packed, spec, cfg)
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launches.items() if v}
    want_counts = {"encoder_layer_with_stem": 1,
                   "encoder_layer": m.enc_layer - 1 + m.dec_layer,
                   "decoder_layer_zero": 1, "decoder_layer": m.dec_layer - 1}
    if counts != want_counts:
        raise AssertionError(f"(n) f32 forward {tag} launches {counts}, "
                             f"expected {want_counts}")
    with torch.no_grad(), full_f32():
        plain = model32(spec)
    errs = {k: rel_err(got[k], plain[k], 1.0) for k in plain}
    bad = {k: e for k, e in errs.items() if not e <= F32_FORWARD_REL[k[-1]]}
    if bad:
        raise AssertionError(f"(n) f32 forward {tag}: {bad} of max(1, "
                             f"|plain f32|) > {F32_FORWARD_REL}")
    with torch.no_grad():
        ms = cuda_ms(lambda: engine.forward(packed, spec, cfg), iters=5)
        with full_f32():
            plain_ms = cuda_ms(lambda: model32(spec), iters=2)
    audio_s = BATCH * cfg.input.num_frame * cfg.feature.hop_sample / SR
    out = {"ms": ms, "plain_ms": plain_ms}
    log(f"(n.4) batch-{BATCH} f32 forward {tag} (hid {m.hid_dim}, "
        f"{m.enc_head} heads): engine vs plain f32 (of max(1, |plain|), <= "
        f"{F32_FORWARD_REL}): "
        + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
        + f"; launches {counts}; engine {ms:.3f} ms ({audio_s / ms * 1e3:.1f} "
        f"audio-s/s), plain f32 {plain_ms:.3f} ms; card {card}")
    profile_forward(lambda: engine.forward(packed, spec, cfg), iters=3,
                    phase="n", top=8)
    if with_int8:
        packed8 = engine.pack_params(model32, torch.float32,
                                     precision="int8")

        def plain_q8_forward():
            kept = {n: getattr(lq, n) for n in Q8_SOURCES}
            try:
                for n in Q8_SOURCES:
                    setattr(lq, n, getattr(lq, n + "_plain"))
                with full_f32():
                    return engine.forward(packed8, spec, cfg)
            finally:
                for n, fn in kept.items():
                    setattr(lq, n, fn)

        out8 = engine.forward(packed8, spec, cfg)
        outp = plain_q8_forward()
        worst, scheme, failed = {}, {}, []
        for k in got:
            if k.startswith("velocity"):
                continue
            p32 = torch.sigmoid(got[k].float())
            worst[k] = (torch.sigmoid(out8[k].float()) - p32).abs().max().item()
            scheme[k] = (torch.sigmoid(outp[k].float()) - p32).abs().max().item()
            # (k)'s gates; where the W8A8 scheme itself (the plain q8
            # forward) lands past Q8_POST on an A head, that head takes the
            # B heads' rule alone
            if not (worst[k] <= Q8_FORWARD_REL * scheme[k]
                    and (k.endswith("_B") or scheme[k] > Q8_POST
                         or worst[k] <= Q8_POST)):
                failed.append(f"{k}: {worst[k]:.4f} from the f32 forward, "
                              f"plain q8 {scheme[k]:.4f}")
        if failed:
            raise AssertionError("(n) f32 int8 forward: " + "; ".join(failed))
        with torch.no_grad():
            ms8 = cuda_ms(lambda: engine.forward(packed8, spec, cfg), iters=5)
        out["int8_ms"] = ms8
        log(f"(n.4) batch-{BATCH} int8 forward {tag}, f32 activations: "
            f"posteriors from the f32 forward (plain q8 in brackets) "
            + ", ".join(f"{k} {v:.4f} ({scheme[k]:.4f})"
                        for k, v in worst.items())
            + f"; A heads <= {Q8_POST} where the plain q8 forward is, all <= "
            f"{Q8_FORWARD_REL} x plain q8; {ms8:.3f} ms "
            f"({audio_s / ms8 * 1e3:.1f} audio-s/s)")
        del out8, outp, packed8
    del got, plain, packed
    torch.cuda.empty_cache()
    return out


def default_cli_f32(feat, audio, cli_main) -> None:
    """(n.5): the CLI with no ``--config`` (the default ``Config()``,
    float32) on ``--device cuda``: ``train`` (3 steps of 16) ->
    ``transcribe --list`` with its checkpoint -> ``evaluate``, then
    ``transcribe --int8``, each with exact non-zero launch counts."""
    from nylon_amt_tpu_torch import Config, kernels
    from nylon_amt_tpu_torch.data.lists import CorpusList
    from nylon_amt_tpu_torch.midi.smf import write_notes
    from nylon_amt_tpu_torch.utils.wavio import save_wav

    cfg = Config()
    m = cfg.model
    if m.compute_dtype != "float32" or m.hid_dim // m.enc_head != 32:
        raise AssertionError(f"the default model is not f32 at head_dim 32: "
                             f"{m}")
    n_frames = 1 + int(AUDIO_SEC * SR) // cfg.feature.hop_sample
    n_batches = math.ceil(math.ceil(n_frames / cfg.input.num_frame) / BATCH)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        write_corpus(cfg, feat, tmp / "corpus")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = cli_main(["train", "--dataset", str(tmp / "corpus"), "--out",
                       str(tmp / "run"), "--epochs", "1", "--batch-size",
                       "16", "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.launches)
        perf = json.loads((tmp / "run" / "performance.json").read_text())
        losses = perf["loss_train"] + perf["loss_valid"]
        if rc != 0 or not all(map(math.isfinite, losses)):
            raise AssertionError(f"(n) train: rc {rc}, losses {losses}")
        steps = 3                       # 48 train windows, batch 16
        per_step = {"hash_keep_mask": 4,
                    "encoder_layer_train": m.enc_layer + m.dec_layer,
                    "encoder_layer_train_bwd": m.enc_layer + m.dec_layer,
                    "decoder_layer_zero_train": 1,
                    "decoder_layer_zero_train_bwd": 1,
                    "decoder_layer_train": m.dec_layer - 1,
                    "decoder_layer_train_bwd": m.dec_layer - 1}
        want = {k: v * steps for k, v in per_step.items()}
        want.update(dict.fromkeys(MHA_SOURCES, 0))   # no per-site path
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"(n) train launches {got}, expected {want}")
        ckpt = tmp / "run" / "checkpoints" / "model_000_000" / "model.dat"
        save_wav(str(tmp / "piece.wav"), audio, SR)
        write_notes(str(tmp / "piece.mid"), synth_notes(AUDIO_SEC))
        cl = CorpusList()
        cl.add("test", "piece", str(tmp / "piece.wav"), str(tmp / "piece.mid"))
        cl.save(str(tmp / "lists"))
        runs = {}
        for label, extra in (("exact", []), ("int8", ["--int8"])):
            torch.cuda.synchronize()
            kernels.reset_launches()
            rc = cli_main(["transcribe", "--checkpoint", str(ckpt), "--list",
                           str(tmp / "lists"), "--split", "test", "--out",
                           str(tmp / label), "--batch-windows", str(BATCH),
                           *extra, "--device", "cuda"])
            torch.cuda.synchronize()
            t_counts = {k: v for k, v in kernels.launches.items() if v}
            sfx = "_q8" if label == "int8" else ""
            t_want = {"log_mel": 1, f"encoder_layer_with_stem{sfx}": n_batches,
                      f"encoder_layer{sfx}": n_batches * (m.enc_layer - 1
                                                          + m.dec_layer),
                      f"decoder_layer_zero{sfx}": n_batches,
                      f"decoder_layer{sfx}": n_batches * (m.dec_layer - 1)}
            if rc != 0 or t_counts != t_want:
                raise AssertionError(f"(n) transcribe {label}: rc {rc}, "
                                     f"launches {t_counts}, expected "
                                     f"{t_want}")
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli_main(["evaluate", "--list", str(tmp / "lists"),
                               "--split", "test", "--est-dir",
                               str(tmp / label), "--out",
                               str(tmp / f"scores_{label}.json")])
            res = json.loads((tmp / f"scores_{label}.json").read_text())
            if rc != 0 or "piece.notes.json" not in res["note"]["per_file"]:
                raise AssertionError(f"(n) evaluate {label}: rc {rc}, {res}")
            notes = json.loads((tmp / label / "piece.notes.json").read_text())
            runs[label] = (t_counts, len(notes),
                           res["note"]["mean"].get("F-measure", float("nan")))
    log(f"(n.5) cli with no --config (Config(): float32, hid {m.hid_dim}, "
        f"{m.enc_head} heads of 32): train 1 epoch, {steps} steps of 16, "
        f"{wall:.2f} s wall, loss train {perf['loss_train'][0]:.5f}, valid "
        f"{perf['loss_valid'][0]:.5f}; launches per step {per_step}, "
        f"per-site K10-K12 0; "
        + "; ".join(f"transcribe{' --int8' if k == 'int8' else ''} --list: "
                    f"{n} notes, launches {c}, evaluate note F {f:.4f}"
                    for k, (c, n, f) in runs.items()))


def time_train_step_f32(cfg, feat, dev, card: str) -> float:
    """(n): the default fused train step (float32, batch 8) by CUDA
    events, and its profile."""
    from nylon_amt_tpu_torch.data.corpus import SplitArrays
    from nylon_amt_tpu_torch.data.windows import WindowDataset

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        write_corpus(cfg, feat, Path(tmp) / "corpus")
        ds = WindowDataset(SplitArrays.load(str(Path(tmp) / "corpus"),
                                            "train"), cfg,
                           n_slice=cfg.train.n_slice)
        first = next(ds.batches(cfg.train.batch_size))
    return time_train_step(cfg, first, dev, card, phase="n",
                           what="default-config f32 ")


def check_float32(feat, audio, spec, dev, card, cli_main) -> dict:
    """(n): the default ``Config()`` in float32 (hid 64 over 2 heads:
    head_dim 32), and the f32 kernels at the paper widths (head_dim 64):
    (n.1) K10-K12 at D = 32 and 64; (n.2) K2-K5 at batch 32 and K7-K9
    forward and backward at batch 8, at the default and the paper widths;
    (n.3) K13 at D = 32 in bf16 and f32; (n.4) the engine's
    f32 forward at the default and the paper config, and the default
    config's int8 forward; (n.5) the CLI with no ``--config``; times of
    each. Returns the f32 times per wrapper."""
    from nylon_amt_tpu_torch import Config, ModelConfig
    from nylon_amt_tpu_torch.models.hft import HFT
    from nylon_amt_tpu_torch.models.init import reference_initialize
    from nylon_amt_tpu_torch.infer import engine

    times = {}
    cfg = Config()
    m = cfg.model
    paper = Config(model=ModelConfig.paper_scale())
    if m.compute_dtype != "float32" or paper.model.compute_dtype != "float32":
        raise AssertionError("Config() and paper_scale() are not float32")

    # (n.1) the attention kernels, D = 32 and D = 64
    for hid, heads in ((m.hid_dim, m.enc_head), (256, 4)):
        for name, r in check_attention_f32(dev, heads, hid).items():
            times[f"{name}/D{hid // heads}"] = r

    # (n.2) the layer kernels at the default widths, K3 and K7 at paper's
    gen = torch.Generator().manual_seed(SEED + 13)
    model32 = reference_initialize(HFT(cfg, dev), gen).eval()
    packed = engine.pack_params(model32, torch.float32)
    names = ("encoder_layer_with_stem", "encoder_layer", "encoder_layer/time",
             "decoder_layer_zero", "decoder_layer")
    train_names = ("encoder_layer_train", "encoder_layer_train/time",
                   "decoder_layer_zero_train", "decoder_layer_train")
    times.update(check_layers_f32(cfg, packed, spec, dev, names, "default"))
    times.update(check_train_layers_f32(model32, cfg, dev, train_names,
                                        "default"))
    del packed
    gen = torch.Generator().manual_seed(SEED + 14)
    paper32 = reference_initialize(HFT(paper, dev), gen).eval()
    packed = engine.pack_params(paper32, torch.float32)
    times.update({f"{k}/paper": v for k, v in check_layers_f32(
        paper, packed, spec, dev, names, "paper").items()})
    times.update({f"{k}/paper": v for k, v in check_train_layers_f32(
        paper32, paper, dev, train_names, "paper").items()})
    del packed
    torch.cuda.empty_cache()

    # (n.3) K13 at head_dim 32, bf16 and f32
    model16 = HFT(dataclasses.replace(cfg, model=dataclasses.replace(
        m, compute_dtype="bfloat16")), dev)
    model16.load_state_dict(model32.state_dict())
    model16.eval()
    times.update(check_int8_d32(model16, model32, cfg, spec, dev))
    del model16
    # and in f32 at the paper widths (head_dim 64)
    times.update(check_int8_d32(None, paper32, paper, spec, dev, "/paper"))

    # (n.4) the engine's f32 forwards
    fwd = check_forward_f32(cfg, model32, spec, dev, card, "default Config()",
                            with_int8=True)
    fwd_paper = check_forward_f32(paper, paper32, spec, dev, card,
                                  "paper_scale()", with_int8=False)
    del paper32
    torch.cuda.empty_cache()
    step_ms = time_train_step_f32(cfg, feat, dev, card)
    log(f"(n) end to end, f32: default Config() batch-{BATCH} forward "
        f"{fwd['ms']:.3f} ms (int8 {fwd['int8_ms']:.3f} ms), paper_scale() "
        f"{fwd_paper['ms']:.3f} ms, default train step (batch "
        f"{cfg.train.batch_size}) {step_ms:.3f} ms; card {card}")

    # (n.5) the CLI with no --config
    default_cli_f32(feat, audio, cli_main)
    return times


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    if not (ROOT / "nylon_amt_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no nylon_amt_tpu_torch/csrc beside "
                         f"{Path(__file__).name}; run it from a checkout")
    os.environ.setdefault("NYLON_NATIVE_CACHE", str(ROOT / "build" / "native"))
    from nylon_amt_tpu_torch import (
        Config, MidiFile, ModelConfig, kernels)
    from nylon_amt_tpu_torch.cli import main as cli_main
    from nylon_amt_tpu_torch.infer import engine
    from nylon_amt_tpu_torch.models.hft import HFT
    from nylon_amt_tpu_torch.models.init import reference_initialize
    from nylon_amt_tpu_torch.ops import layer_fused as lf
    from nylon_amt_tpu_torch.ops.mel import MelFrontend
    from nylon_amt_tpu_torch.ops.precision import full_f32
    from nylon_amt_tpu_torch.ops.spectrogram import log_mel, log_mel_plain
    from nylon_amt_tpu_torch.utils.wavio import save_wav

    dev = torch.device("cuda:0")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    rng = np.random.default_rng(SEED)
    results = {}

    # (a) build ---------------------------------------------------------------
    t0 = time.perf_counter()
    kernels.load()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in
             (kernels.build_dir() / "build.log").read_text().splitlines()
             if "Used" in ln or "spill" in ln]
    log(f"(a) built {kernels.build_dir() / kernels.LIB_NAME} in "
        f"{build_s:.1f} s; ptxas: " + " | ".join(ptxas))

    # (b) K1 log-mel ------------------------------------------------------------
    # The f32 DFT of the lowest mel bins of zero-mean audio is a sum with
    # heavy cancellation: there, any two f32 summation orders (the kernel's
    # and cuBLAS's) differ by more than 2e-4 in log-mel. So the kernel is
    # held within 2e-4 of a float64 truth, on the smoke's audio and on a
    # quiet variant (noise floor 0.01), where the cancellation is worst.
    cfg = Config(model=dataclasses.replace(ModelConfig.paper_scale(),
                                           compute_dtype="bfloat16"))
    fe = MelFrontend(cfg.feature, dev)
    audio = synth_audio(AUDIO_SEC, rng)
    quiet = synth_audio(AUDIO_SEC, np.random.default_rng(SEED + 1), 0.01)
    k1 = {}
    for label, samples in (("main", audio), ("quiet", quiet)):
        w = torch.from_numpy(samples).to(dev)
        got = log_mel(w, fe)
        ref = log_mel_plain(w, fe)
        frames = fe.frame(w).double()
        re, im = frames @ fe.cos_w.double().T, frames @ fe.sin_w.double().T
        ref64 = torch.log((re * re + im * im) @ fe.fb.double()
                          + cfg.feature.log_offset)
        del frames, re, im
        err64 = (got.double() - ref64).abs().max().item()
        k1[label] = dict(
            err64=err64, plain_err64=(ref.double() - ref64).abs().max().item(),
            diff=(got - ref).abs().max().item())
        if got.shape != ref64.shape or not err64 <= K1_ATOL:
            raise AssertionError(f"K1 log_mel ({label} audio): shape "
                                 f"{tuple(got.shape)} vs {tuple(ref.shape)}, "
                                 f"{err64} from float64 (atol {K1_ATOL})")
    held("log_mel", torch.float32)
    wav = torch.from_numpy(audio).to(dev)
    ms = cuda_ms(lambda: log_mel(wav, fe), iters=10)
    plain_ms = cuda_ms(lambda: log_mel_plain(wav, fe), iters=10)
    n_freq, n_fft = fe.cos_w.shape
    t_frames, n_mels = got.shape
    results["log_mel"] = dict(
        max_abs_err=k1["main"]["err64"], ms=ms, plain_ms=plain_ms,
        **bound(nbytes(wav, got, *fe.kernel_bases),
                f32_flops=2 * t_frames * n_fft * n_freq * 2
                + 2 * t_frames * n_freq * n_mels),
        library_ms=None,
        gate=f"atol {K1_ATOL} from float64 (main {k1['main']['err64']:.3e}, "
             f"quiet {k1['quiet']['err64']:.3e})")
    for label, r in k1.items():
        log(f"(b) K1 log_mel, {label} audio [{wav.shape[0]}] -> "
            f"[{got.shape[0]}, {got.shape[1]}]: from float64 kernel "
            f"{r['err64']:.3e} (atol {K1_ATOL}), plain f32 "
            f"{r['plain_err64']:.3e}; kernel vs plain {r['diff']:.3e}")
    log(f"(b) K1 log_mel: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")

    # the batch of windows of (c)'s K2 check and of (e), from the features
    feat = fe(wav)
    pad = torch.full((cfg.input.margin_b, feat.shape[1]), cfg.input.min_value,
                     device=dev)
    padded = torch.cat([pad, feat, pad])
    spec = torch.stack([padded[i * 128: i * 128 + cfg.window_frames].T
                        for i in range(BATCH)]).contiguous()

    # (c) K2 / K3 / K4 / K5 -----------------------------------------------------
    gen = torch.Generator().manual_seed(SEED)
    cfg32 = Config(model=ModelConfig.paper_scale())
    model = reference_initialize(HFT(cfg, dev), gen).eval()
    model32 = HFT(cfg32, dev)
    model32.load_state_dict(model.state_dict())
    model32.eval()
    packed = engine.pack_params(model, torch.bfloat16)
    packed32 = engine.pack_params(model32, torch.float32)
    m = cfg.model
    n_frame = cfg.input.num_frame
    results.update(check_layers(cfg, packed, packed32, spec, dev))

    # (d) the whole slice through the CLI ---------------------------------------
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        tmp = Path(tmp)
        cfg.save(str(tmp / "config.json"))
        torch.save({"model_dict": {k: v.cpu() for k, v in
                                   model.state_dict().items()}},
                   tmp / "model.dat")
        save_wav(str(tmp / "piece.wav"), audio, SR)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = cli_main(["transcribe", "--checkpoint", str(tmp / "model.dat"),
                       "--config", str(tmp / "config.json"),
                       "--wav", str(tmp / "piece.wav"), "--out",
                       str(tmp / "out"), "--batch-windows", str(BATCH),
                       "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kernels.launches)
        if rc != 0:
            raise AssertionError(f"transcribe returned {rc}")
        midi = MidiFile.read(str(tmp / "out" / "piece.mid"))
        notes = json.loads((tmp / "out" / "piece.notes.json").read_text())
    log(f"(d) transcribe {AUDIO_SEC:.0f} s WAV -> {len(notes)} notes, MIDI "
        f"with {len(midi.tracks)} track(s); {wall:.2f} s wall (host clock, "
        f"model load and decode included)")

    # (f) launch counts of (d) --------------------------------------------------
    n_frames = 1 + int(AUDIO_SEC * SR) // cfg.feature.hop_sample
    n_batches = math.ceil(math.ceil(n_frames / n_frame) / BATCH)
    want = {"log_mel": 1, "encoder_layer_with_stem": n_batches,
            "encoder_layer": n_batches * (m.enc_layer - 1 + m.dec_layer),
            "decoder_layer_zero": n_batches,
            "decoder_layer": n_batches * (m.dec_layer - 1)}
    want.update({k: 0 for k in counts if k not in want})  # training
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    log(f"(f) launches in (d): {counts} ({n_batches} batches of {BATCH})")

    # (e) engine vs plain model on one batch ------------------------------------
    got = engine.forward(packed, spec, cfg)
    with torch.no_grad():
        plain16 = model(spec)
        with full_f32():
            truth = model32(spec)
    failed = []
    for k in truth:
        try:
            e_k, e_p = bf16_gate(f"engine {k}", got[k], plain16[k], truth[k])
        except AssertionError as e:
            failed.append(str(e))
            e_k = e_p = float("nan")
        err, ulps = ulp_distance(got[k], plain16[k])
        ulp_bound = ULPS_FORWARD[k[-1]]
        if not ulps <= ulp_bound:
            failed.append(f"engine {k}: {ulps:.1f} ulps from plain bf16 > "
                          f"{ulp_bound}")
        log(f"(e) {k}: engine err {e_k:.5f} vs plain bf16 err {e_p:.5f}; "
            f"engine vs plain bf16 max abs {err:.4f} = {ulps:.1f} ulps "
            f"(<= {ulp_bound}) of max |plain bf16| "
            f"{plain16[k].float().abs().max().item():.3f}")
    if failed:
        raise AssertionError("; ".join(failed))
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: engine.forward(packed, spec, cfg), iters=10)
        plain_fwd_ms = cuda_ms(lambda: model(spec), iters=3)
    audio_s = BATCH * n_frame * cfg.feature.hop_sample / SR
    log(f"(e) batch-{BATCH} paper bf16 forward: engine {fwd_ms:.3f} ms "
        f"({audio_s / fwd_ms * 1e3:.1f} audio-s/s), plain HFT.forward "
        f"{plain_fwd_ms:.3f} ms ({audio_s / plain_fwd_ms * 1e3:.1f} "
        f"audio-s/s); card {card}")
    profile_forward(lambda: engine.forward(packed, spec, cfg))

    # (g) K6 -------------------------------------------------------------------
    results["hash_keep_mask"] = check_masks(dev)

    # (h) K7 / K8 / K9 ---------------------------------------------------------
    k3k5 = {"enc": lf.encoder_layer, "dec_zero": lf.decoder_layer_zero,
            "dec": lf.decoder_layer}
    results.update(check_train_layers(model, cfg, dev, k3k5))
    del model32, packed32
    torch.cuda.empty_cache()

    # (i) training through the CLI ---------------------------------------------
    train_counts, first_batch = train_through_cli(cfg, feat, audio, cli_main)

    # (j) the train step's time ------------------------------------------------
    fused_step_ms = time_train_step(cfg, first_batch, dev, card)

    # (k) K13, the int8 layers -------------------------------------------------
    q8_counts, q8_results = check_int8(cfg, model, packed, spec, audio, dev,
                                       card, cli_main)
    results.update(q8_results)

    # (l) K10 / K11 / K12, the per-site attention ---------------------------
    results.update(check_attention_kernels(dev))
    check_return_attention_forward(cfg, model, packed, spec, dev, fwd_ms)
    mha_counts, _ = per_site_through_cli(cfg, feat, audio, dev, card,
                                         cli_main)
    rep = dataclasses.replace
    for name, over in (("--remat", dict(remat=True)),
                       ("1FLT", dict(dec_alg="linear_satime")),
                       ("2FDT", dict(enc_alg="cnnblock_safreq"))):
        ms = time_train_step(rep(cfg, model=rep(cfg.model, **over)),
                             first_batch, dev, card, phase="l",
                             what=f"{name} per-site ")
        log(f"(l) {name} per-site train step {ms:.3f} ms against (j)'s fused "
            f"step {fused_step_ms:.3f} ms ({ms / fused_step_ms:.2f}x)")

    # (m) head_dim 32: the default configuration ---------------------------
    check_default_config(feat, audio, spec, dev, card, cli_main)

    # (n) the default Config() in float32 ----------------------------------
    f32_times = check_float32(feat, audio, spec, dev, card, cli_main)

    loaded = sorted(n for n in sys.modules if n.split(".")[0] in
                    ("jax", "jaxlib", "flax", "nylon_amt_tpu"))
    if loaded:
        raise AssertionError(f"JAX or the JAX package was imported: "
                             f"{loaded[:5]}")
    counts.update({k: train_counts[k] for k in (
        "hash_keep_mask", "encoder_layer_train", "encoder_layer_train_bwd",
        "decoder_layer_zero_train", "decoder_layer_zero_train_bwd",
        "decoder_layer_train", "decoder_layer_train_bwd")})
    train = "nylon_amt_tpu/ops/layer_fused_train.py"
    sources = {
        "log_mel": ("log_mel.cu", "nylon_amt_tpu/ops/spectrogram_pallas.py:124"),
        "encoder_layer_with_stem": ("stem_embed.cu",
                                    "nylon_amt_tpu/ops/layer_fused.py:376"),
        "encoder_layer": ("layer_fused.cu", "nylon_amt_tpu/ops/layer_fused.py:301"),
        "decoder_layer_zero": ("layer_fused.cu",
                               "nylon_amt_tpu/ops/layer_fused.py:405"),
        "decoder_layer": ("layer_fused.cu", "nylon_amt_tpu/ops/layer_fused.py:429"),
        "hash_keep_mask": ("hash_mask.cu", "nylon_amt_tpu/ops/attention.py:55"),
        "encoder_layer_train": ("layer_fused.cu", f"{train}:443"),
        "encoder_layer_train_bwd": ("layer_fused_train.cu", f"{train}:472"),
        "decoder_layer_zero_train": ("layer_fused.cu", f"{train}:759"),
        "decoder_layer_zero_train_bwd": ("layer_fused_train.cu",
                                         f"{train}:789"),
        "decoder_layer_train": ("layer_fused.cu", f"{train}:759"),
        "decoder_layer_train_bwd": ("layer_fused_train.cu", f"{train}:789"),
        **{name: ("layer_fused_q8.cu", tpu) for name, tpu in
           Q8_SOURCES.items()},
        **{name: ("mha.cu", tpu) for name, tpu in MHA_SOURCES.items()}}
    counts.update({k: q8_counts[k] for k in Q8_SOURCES})
    counts.update(mha_counts)
    # the sources of each wrapper's float32 path
    layer32, train32 = ["layer_fused_f32.cu", "mha_f32.cu"], [
        "layer_fused_f32.cu", "layer_fused_train.cu", "mha_f32.cu"]
    f32_sources = {
        "log_mel": ["log_mel.cu"],
        "encoder_layer_with_stem": ["stem_embed.cu", *layer32],
        "encoder_layer": layer32, "decoder_layer_zero": layer32,
        "decoder_layer": layer32, "hash_keep_mask": ["hash_mask.cu"],
        "encoder_layer_train": layer32, "decoder_layer_zero_train": layer32,
        "decoder_layer_train": layer32, "encoder_layer_train_bwd": train32,
        "decoder_layer_zero_train_bwd": train32,
        "decoder_layer_train_bwd": train32,
        **{n: ["mha_f32.cu"] for n in MHA_SOURCES},
        **{n: ["layer_fused_q8.cu"] for n in Q8_SOURCES}}
    f32_sources["encoder_layer_with_stem_q8"].insert(0, "stem_embed.cu")
    log(card)  # name, power limit: nvidia-smi's own line
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"nylon_amt_tpu_torch/csrc/{src}", "replaces": tpu,
         "launches": counts[name], **results[name],
         "held": sorted(HELD.get(name, ())),
         "f32_sources": [f"nylon_amt_tpu_torch/csrc/{f}"
                         for f in f32_sources[name]],
         "f32": {k: v for k, v in f32_times.items()
                 if k.split("/")[0] == name}}
        for name, (src, tpu) in sources.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
