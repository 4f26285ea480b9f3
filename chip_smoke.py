"""Drive the PyTorch / CUDA port on one GPU, end to end.

Run from the root of a checkout on a machine with a CUDA card:

    python chip_smoke.py

Phases (each prints one line; any failed check raises, so the script exits
non-zero and never prints the last line):

(a) build the kernels of ``nylon_amt_tpu_torch/csrc`` with nvcc (sm_90a);
    the wgmma / TMA GEMMs of ``csrc/layer_fused.cu`` (``gemm_bias_kernel``,
    ``gemm_res_ln_kernel``), ``csrc/layer_fused_train.cu``
    (``gemm_nt_kernel``, ``wgrad_kernel``) and ``csrc/layer_fused_f32.cu``
    (``gemm_bias_f32_kernel``, ``gemm_res_ln_f32_kernel``,
    ``gemm_nt_f32_kernel``, ``wgrad_f32_kernel``: 3xTF32) spill nothing
    and use no stack in ``ptxas -v``, and where the toolkit has
    ``cuobjdump`` their SASS holds HGMMA (wgmma) and UTMALDG (TMA load)
    instructions; the TMA-fed kernels of the f32-exact products
    (``log_mel_kernel`` of ``csrc/log_mel.cu``, on the FP64 tensor cores,
    and ``gemm_bias_ffma_kernel`` of ``csrc/layer_fused_f32.cu``, the stem
    QKV on the CUDA cores) likewise spill nothing, use no stack, and hold
    UTMALDG and DMMA (K1) or FFMA (the QKV) instructions; the int8 GEMMs and
    attention of ``csrc/layer_fused_q8.cu`` (``gemm_q8_bias_kernel``,
    ``gemm_q8_res_ln_kernel``, ``attention_q8_kernel``: s8 ``wgmma``, bf16
    and f32) spill nothing, use no stack (``gemm_q8_bias_kernel``: 168
    registers, the setmaxnreg balance), and hold IGMMA (int8 wgmma) and
    UTMALDG and no IMMA (``mma.sync``); every instantiation of the bf16
    attention of ``csrc/mha.cu`` (``attn_fwd_kernel``, ``attn_bwd_kernel``:
    D 32 and 64, key tiers 96, 128 and 256, the forward plain, with K11's
    probabilities and with dropout, the backward plain and with dropout)
    spills nothing, uses no stack, and holds HGMMA and UTMALDG and no HMMA
    (``mma.sync``); so does every instantiation of the f32 attention of
    ``csrc/mha_f32.cu`` (``attn_fwd_f32_kernel``,
    ``attn_fwd_ffma_f32_kernel``, ``attn_bwd_f32_kernel``,
    ``attn_bwd_ffma_f32_kernel``: 3xTF32 ``wgmma`` fed by TMA); and every
    instantiation of the TMA-fed streaming kernels (``ln_bwd_kernel`` of
    ``csrc/layer_fused_train.cu``, ``quant_cols_kernel`` of
    ``csrc/layer_fused_q8.cu``) spills nothing, uses no stack and holds
    UTMALDG;
(b) K1, the log-mel kernel, within atol 2e-4 of a float64 truth on 120 s of
    seeded audio, on a quiet variant of it (see the check) and on 10 s of
    other audio (the card's partial wave), two runs bit-identical; the
    kernel's and the plain f32 version's float64 distances; the kernel's
    time beside its bound, the plain version's and the CUDA-core kernel's
    it replaced (K1_SIMT_MS);
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
    plain q8 version + 4 ulps, and bit for bit the same run with its
    inputs' row codes handed in (``x_codes`` ...), its ``codes_out`` those
    of ``_quant_rows`` of its output; the profiled int8 forward launches
    ``quant_rows_kernel`` at most 3 times (every other GEMM input leaves
    the kernel that makes it as codes) and ``attention_q8_kernel`` once a
    site; the int8 forward's
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
    Each (l) time prints beside its bound, SDPA's and, where ``PERF.md``
    has them, the times of the ``mma.sync`` kernels that the wgmma ones of
    ``csrc/mha.cu`` replaced (MMA_SYNC_MS) and of the ``wmma`` kernels
    before them (WMMA_MS);
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
    bit-identical backward runs; the blocks per SM of the kernels; times by
    CUDA graphs of the kernel's call beside the earlier ``mma.sync`` and
    all-FFMA kernels' (MMA_F32_MS, FFMA_F32_MS), f32 SDPA, and three
    bounds: the products as they run (every product as 3xTF32; K11 also a
    pass of its scores on FFMA), all as 3xTF32, all on FFMA; (n.2) K2-K5 at
    batch 32 and K7-K9 forward and backward at batch 8, at the default and
    the paper widths, under the same limits (ReLU gate flips aside), with
    (h)'s stage hook (every backward kernel on the twin's inputs within
    1e-5 of the twin's stage); K7 also as training runs it on the stem's
    output (its QKV on FFMA, its attention backward's scores on FFMA: that
    stage too within 1e-5 of the twin's), and at rate 0 with its float64
    distance;
    K2-K5's and the plain f32 version's
    distances from a float64 truth (``layer64``); times beside f32
    ``torch.matmul`` of the layer's GEMMs; (n.3) K13 at head_dim 32 in
    bf16 and f32 (quantizers bit for bit, (k)'s gates and codes handed in,
    and in f32 each kernel on the plain version's own codes), K13 in f32 at
    the paper widths (head_dim 64) and at hid 96 over 3 heads, pf 160, in
    bf16 and f32 (every layer but the stem's: see the call) under the same
    gates; (n.4) the engine's batch-32 f32 forward of ``Config()``,
    ``paper_scale()`` and hid 96 over 3 heads (pf 160) against the plain
    f32 forward (A heads within 2e-5, B heads within 2e-4 of max(1, max
    |plain|)), the default and hid-96 int8 forwards under (k)'s posterior
    gates, the hid-96 bf16 forward under (m)'s gates (on the f32 / int8
    model's weights its B heads' end-to-end ulps printed, not held, beside
    the stage-wise gate; on a second seed all held: see the call), the
    default f32 train step; (n.5) ``cli train`` (3 steps) ->
    ``transcribe --list`` -> ``evaluate``, then ``transcribe --int8`` and
    ``evaluate``, all with no ``--config``, with their launch counts.
(o) the bf16 layer GEMMs alone (``gemm_bias_kernel``, ``gemm_res_ln_kernel``
    of ``csrc/layer_fused.cu``) at every (M, K, N) and variant of the paper
    batch-32 forward, the paper batch-8 training forward (dropout sites,
    ``pre_out``, ``out`` None), the default widths and a ragged geometry
    (hid 96, pf 160, M not a multiple of 128): within 4 bf16 ulps of the
    plain twin (``gemm_bias_plain`` / ``gemm_res_ln_plain``) and under the
    bf16 gate, ``pre_out`` likewise, two runs bit-identical; per shape the
    kernel's time, its bound (bytes or FLOPs), TB/s and share of the bound,
    and bf16 ``torch.matmul`` of the same product (+ ``F.layer_norm`` for
    the LayerNorm GEMM) as the library yardstick.
(p) the bf16 backward GEMMs alone (``gemm_nt_kernel``, dX = dY W^T with its
    epilogue, and ``wgrad_kernel``, dW = A^T dY with the bias sums, of
    ``csrc/layer_fused_train.cu``) at every product and variant of a batch-8
    training step's backward (``tools/gemm_ab.py::step_bwd_products``: the
    paper widths' 43 + 43 launches, the default widths' and the ragged
    geometry's 28 + 28): dX within 4 bf16 ulps of ``gemm_nt_plain`` and
    under the bf16 gate, dW and the bias sums no further from a float64
    truth of the same bf16 operands than twice the plain f32 twin's own
    distance + 1e-6 max |truth|, two runs bit-identical; per shape the
    kernel's time, its bound, TB/s and share of the bound, and bf16
    ``torch.matmul`` of the same product; the step's sums.
(q) the f32 forward GEMMs alone (``gemm_bias_f32_kernel``,
    ``gemm_res_ln_f32_kernel`` of ``csrc/layer_fused_f32.cu``: 3xTF32 on
    ``wgmma``) at every (M, K, N) and variant of (o) in float32, and the
    stem layer's QKV GEMM on FFMA (``gemm_bias_ffma_kernel``, TMA-fed) at its
    shapes: within 2e-5 of max(1, max |plain f32 twin|), ``pre_out``
    likewise, two runs bit-identical, with the kernel's and the twin's
    distances from a float64 truth (the QKV's within twice the twin's + 4
    f32 ulps of max(1, max |truth|)); per shape the kernel's time beside its
    bound (bytes, or the products as 3xTF32 at 494.7 / 3 TFLOP/s; FFMA's
    at 67 TFLOP/s), the FFMA bound, f32 ``torch.matmul`` (IEEE f32) and
    the plain twin; the three kernels' rows of the JSON line: the paper
    batch-32 forward's shapes summed over its launches, the launches
    those that (n.4)'s paper f32 forward counted.
(r) the f32 backward GEMMs alone (``gemm_nt_f32_kernel``, dX on
    ``wgmma``, and ``wgrad_f32_kernel``, dW on ``wgmma`` with dY re-staged
    as a K-major TF32 pair, of ``csrc/layer_fused_f32.cu``: 3xTF32) at
    every product of (p) in float32: dX within 2e-5 of max(1, max |plain f32
    twin|), dW and the bias sums no further from a float64 truth than twice
    the plain f32 twin's own distance + 1e-6 max |truth|, two runs
    bit-identical; per shape the kernel's time beside its bound (bytes, or
    the products as 3xTF32), f32 ``torch.matmul`` of the same product (the
    two by CUDA graphs of 20 calls, as ``gemm_ab.graph_ms`` times them)
    and the plain twin; the two
    kernels' rows of the JSON line: the default batch-8 step's products
    summed over their launches, the launches those that (n)'s default f32
    train step counted, and the paper step's sums beside them, its
    launches those of (n.2)'s paper backwards times the model's layers.
(s) the int8 GEMMs alone (``gemm_q8_bias_kernel``, ``gemm_q8_res_ln_kernel``
    of ``csrc/layer_fused_q8.cu``: s8 ``wgmma`` fed by TMA, the weights
    K-major) at every product of the paper batch-32 int8 forward in the
    variant the forward runs it (23 GEMM + bias, with and without ReLU,
    with the row codes of their column segments: Q and K of the QKV
    product, K of the cross KV product, the cross Q, the FFN hidden; 20
    residual + LayerNorm with and without the output's quantization), the
    default widths' and a ragged geometry (hid 96, pf 160, M not a multiple
    of 128), in bf16 and f32, on seeded codes and scales: the GEMM + bias
    bit for bit equal to its plain twin, its codes and scales those of
    ``_quant_rows`` of each segment of the twin's output, the LayerNorm one
    within 4 bf16 ulps
    (f32: 2e-5 of max(1, |plain|)) with its output codes and scales those
    of the row quantizer on its own output, two runs bit-identical; per
    product the kernel's time (CUDA graphs of 20 calls, as (r)) beside its
    bound, the exact kernel of the same product in the same dtype and
    ``torch._int_mm``; the paper forward's sums in every K13 row of the
    JSON line (``s8_gemms``), their launches those that (k) profiled in
    the int8 forward (the run fails unless they are the cases (s) timed);
    the log line beside them quotes PERF.md's times of the ``mma.sync``
    kernels these replaced and of the bf16 GEMMs.
(t) K13's attention and quantizers alone: ``attention_q8_kernel`` (s8
    ``wgmma``, a thread-block cluster of the heads of a sequence, the row
    codes of its output) at the four attention shapes of the paper int8
    forward, at the paper widths, the default widths (head_dim 32) and hid
    96 over 3 heads, bf16 and f32: its output (written on request) under
    (k)'s / (n.3)'s gates against ``attention_q8_plain``, its codes and
    scales ``_quant_rows`` of its own output bit for bit (and the
    codes-only run's), its codes >= 99.9% equal to the twin's and all
    within 1, two runs bit-identical; each time (CUDA graphs) beside its
    bytes bound and the parent tree's kernel (PERF.md: ``tools/gemm_ab.py
    --q8``, A B B A); ``quant_rows_kernel`` at the three inputs the forward
    still gives it, bit for bit, and ``quant_cols_kernel`` at the forward's
    V (strided views of the QKV and KV outputs, a zero column) at the
    paper, default and hid-96 widths in bf16 and f32, bit for bit
    ``quant_cols_plain``'s layout, reruns bit-identical, timed. The JSON
    line gets a row for each of K13's five CUDA kernels: the paper int8
    forward's launches of it ((k)'s profile), summed times and bounds.
(u) the LayerNorm backward alone (``ln_bwd_kernel`` of
    ``csrc/layer_fused_train.cu``, bf16 and f32) at every launch shape of
    (j)'s paper bf16 step and (n)'s default f32 step (their launches
    counted in (j) and (n) and derived from the layer counts), with the
    steps' dropout site and without: da and dam within 4 bf16 ulps of
    ``ln_bwd_plain`` (f32: 2e-5 of max(1, |plain|)), dam bit for bit T(da
    x keep) of the kernel's own da, dgamma and dbeta within 1e-4 of max
    |plain|, reruns bit-identical; each shape's time (CUDA graphs) beside
    its bytes bound, the plain twin and, without dropout,
    ``native_layer_norm_backward``; its JSON row: (j)'s launches summed,
    (n)'s beside them.

Every profile ((e), (j), (k), (l), (m), (n)) also prints the device time
and share of the attention kernels of ``csrc/mha.cu`` and
``csrc/mha_f32.cu``, and of the layer GEMMs (bf16, f32 and int8).

PyTorch's global TF32 flags stay at their defaults: the port's own guards
keep its f32 paths at f32 accuracy (IEEE f32; the f32 attention's PV
product and its backward's products as 3xTF32), and the script wraps only
its own f32 references in ``full_f32``.

Before the last line it prints the card's name and power limit and one JSON
object with, per wrapper, the dtypes and head dims this run held against
its plain version (``held``), its float32 sources and (n)'s f32 times
(``f32``), and its launches (K1-K5 from (d), K6-K9 from (i), K13
from (k), K12 from (l)'s ``--remat`` training, K10 and K11 from its
``return_attention`` training, the f32 GEMMs from (n), the LayerNorm
backward from (j)), error, times and
bound (the larger of the
bytes it must move over 3.35 TB/s and its operations over 989 TFLOP/s bf16,
1,979 TOP/s int8 for K13's products, 494.7 / 3 TFLOP/s for the f32
attention's 3xTF32 products (PV, and every backward product), 67 TFLOP/s
for the FP64 tensor cores' products (K1's DFT), the stem's and the stem
QKV's f32 work, the f32 attention's scores and K12's mask hashes: the H100
SXM's published rates).
The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
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
F32_FLOPS = 67e12    # f32 outside the tensor cores
F64_FLOPS = 67e12    # the FP64 tensor cores (DMMA: K1's DFT)
F32_EPS = 2.0 ** -23  # an f32 ulp at 1
# Time of csrc/log_mel.cu's CUDA-core kernel (f64 FMA on 4 x 4 register
# tiles) that the FP64 tensor-core one replaced, on (b)'s 120 s audio (ms;
# PERF.md section 6: NVIDIA H100 80GB HBM3, 700 W)
K1_SIMT_MS = 6.838
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
                    what: str = "forward", top: int = 12) -> list:
    """Device time per kernel over ``iters`` calls of ``fwd`` (forwards,
    or train steps), by torch.profiler, and the device-busy share of the
    profiled window. Returns (kernel name, ms, launches) per call of
    ``fwd``, for every kernel that ran."""
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
    for dt, src, names in (
            ("bf16", "layer_fused.cu", ("gemm_bias_kernel",
                                        "gemm_res_ln_kernel")),
            ("f32", "layer_fused_f32.cu", ("gemm_bias_f32_kernel",
                                           "gemm_res_ln_f32_kernel")),
            ("int8", "layer_fused_q8.cu", ("gemm_q8_bias_kernel",
                                           "gemm_q8_res_ln_kernel"))):
        gemm = [(ms, calls) for name, ms, calls in rows
                if any(f"::{k}<" in name for k in names)]
        if gemm:
            ms = sum(r[0] for r in gemm)
            log(f"({phase})   {dt} layer GEMMs of csrc/{src} "
                f"({', '.join(names)}): {ms:.3f} ms, {ms / busy:.1%} of "
                f"device-busy, {sum(r[1] for r in gemm)} launches per {what}")
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
    return rows


def bound(nbytes: float, flops: float = 0.0, f32_flops: float = 0.0,
          int8_ops: float = 0.0, tf32x3_flops: float = 0.0,
          f64_flops: float = 0.0) -> dict:
    """The least time the card could take: bytes over the memory rate, or
    operations over the peak rate of their type, whichever is larger
    (``tf32x3_flops``: f32 products taken as three TF32 products each;
    ``f64_flops``: on the FP64 tensor cores)."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = (flops / BF16_FLOPS + f32_flops / F32_FLOPS
             + int8_ops / INT8_OPS + tf32x3_flops / (TF32_FLOPS / 3)
             + f64_flops / F64_FLOPS) * 1e3
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


def mm_ms(gemms, dev, dtype=torch.float32) -> float:
    """Time of ``torch.matmul`` in ``dtype`` (f32: IEEE, no TF32) on a
    layer's GEMM shapes ``[(M, K, N), ...]``, one call each: the library
    yardstick of the layer kernels (the port never calls it)."""
    from nylon_amt_tpu_torch.ops.precision import full_f32

    g = torch.Generator(device=dev).manual_seed(3)
    ops = [(torch.randn((m, k), generator=g, device=dev).to(dtype),
            torch.randn((k, n), generator=g, device=dev).to(dtype))
           for m, k, n in gemms]
    with full_f32():
        return cuda_ms(lambda: [a @ b for a, b in ops], iters=3)


def _ln64(x, g, b):
    m = x.mean(-1, keepdim=True)
    var = (x - m).square().mean(-1, keepdim=True)
    return (x - m) / torch.sqrt(var + 1e-5) * g + b


def _mha64(q, k, v, heads):
    n, lq, hid = q.shape
    lk, d = k.shape[1], hid // heads

    def split(t, L):
        return t.reshape(n, L, heads, d).transpose(1, 2)

    s = split(q, lq) @ split(k, lk).transpose(-1, -2) / math.sqrt(d)
    o = torch.softmax(s, -1) @ split(v, lk)
    return o.transpose(1, 2).reshape(n, lq, hid)


def layer64(kind: str, xs, p, heads: int, chunk: int = 256):
    """The float64 truth of a layer forward (kind "enc", "dec_zero" or
    "dec") on ``xs`` ((x,) or (trg, enc)) and the f32 weights ``p``: the
    plain layer's op sequence with no rounding, ``chunk`` sequences at a
    time. Returns the f64 output."""
    P = {f: t.double() for f, t in zip(p._fields, p)}
    hid = xs[0].shape[-1]

    def lin(x, w, b):
        return x @ P[w] + P[b]

    def ffn_tail(attn, res):
        y = _ln64(res + attn, P["g"], P["b"])
        return _ln64(y + lin(torch.relu(lin(y, "w1", "b1")), "w2", "b2"),
                     P["g"], P["b"])

    def one(*x):
        x = [t.double() for t in x]
        if kind == "enc":
            q, k, v = lin(x[0], "wqkv", "bqkv").split(hid, -1)
            return ffn_tail(lin(_mha64(q, k, v, heads), "wo", "bo"), x[0])
        trg, enc = x
        if kind == "dec":
            q, k, v = lin(trg, "wsqkv", "bsqkv").split(hid, -1)
            trg = _ln64(trg + lin(_mha64(q, k, v, heads), "wso", "bso"),
                        P["g"], P["b"])
        k, v = lin(enc, "wkv", "bkv").split(hid, -1)
        attn = _mha64(lin(trg, "wq", "bq"), k, v, heads)
        return ffn_tail(lin(attn, "wo", "bo"), trg)

    n = xs[0].shape[0]
    return torch.cat([one(*(x[i:i + chunk] for x in xs))
                      for i in range(0, n, chunk)])


def f64_dist(got, truth) -> float:
    """max |got - truth| over max(1, max |truth|) (the f32 gates' scale)."""
    top = max(1.0, truth.abs().max().item())
    return (got.double() - truth).abs().max().item() / top


def layer_gemms(kind: str, n: int, lq: int, lk: int, hid: int,
                pf: int) -> list:
    """The (M, K, N) of a layer forward's projections."""
    gemms = [(n * lq, hid, hid), (n * lq, hid, pf), (n * lq, pf, hid)]
    gemms += ([(n * lq, hid, 3 * hid)] if kind == "enc" else
              [(n * lq, hid, hid), (n * lk, hid, 2 * hid)])
    if kind == "dec":
        gemms += [(n * lq, hid, 3 * hid), (n * lq, hid, hid)]
    return gemms


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


def _layer_fns(kind: str, emb: bool, heads: int, stem: bool = False):
    """(kernel fwd, plain fwd, kernel bwd, plain bwd) of a layer kind, as
    functions of (inputs, params, rate[, dz[, stage hook | taps dict]]);
    ``stem``: the K7 layer that the stem feeds."""
    from nylon_amt_tpu_torch.ops import layer_fused_train as lt

    if kind == "enc":
        return (lambda xs, p, r: lt.encoder_layer_train_cuda(
                    xs[0], p, DROP_SEED, heads, r, emb, stem=stem),
                lambda xs, p, r: lt.encoder_layer_train_plain(
                    xs[0], p, DROP_SEED, heads, r, emb),
                lambda xs, p, r, dz, tap=None: lt.encoder_layer_train_bwd_cuda(
                    xs[0], p, DROP_SEED, dz, heads, r, emb, tap=tap,
                    stem=stem),
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
        # forward recompute, dX and dW: three GEMMs a forward one
        gemms = layer_gemms(kind, n, lq, lk, hid, pf)
        w_bytes = nbytes(*p)
        io = nbytes(*xs)
        chain = max(gate[3] for gate in in_gates)
        held(name, torch.bfloat16, hid // heads)
        held(bwd_name(name), torch.bfloat16, hid // heads)
        results[name] = dict(
            max_abs_err=err, ms=fwd_ms, plain_ms=fwd_plain_ms,
            **bound(io + w_bytes + nbytes(got), flops),
            library_ms=mm_ms(gemms, dev, torch.bfloat16),
            sdpa_piece_ms=sdpa_ms(n, lq, lk, heads, dev, backward=False,
                                  d=hid // heads),
            gate=f"{ulps:.2f} bf16 ulps from plain bf16 <= {ULPS}; bf16 rel "
                 f"err from plain f32 {fe_k:.5f} <= 2 x {fe_p:.5f} + 1e-3; "
                 f"rate 0 {zero_ulps:.2f} ulps from the inference kernels")
        results[name + "_bwd"] = dict(
            max_abs_err=bwd_err, ms=bwd_ms, plain_ms=bwd_plain_ms,
            **bound(2 * io + nbytes(dz) + 2 * w_bytes, 3 * flops),
            library_ms=mm_ms(gemms * 3, dev, torch.bfloat16),
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
            f"bound {results[name + '_bwd']['bound_ms']:.3f} ms; bf16 "
            f"torch.matmul of its GEMMs fwd {results[name]['library_ms']:.3f}"
            f" ms, bwd {results[name + '_bwd']['library_ms']:.3f} ms; SDPA on "
            f"the attention piece fwd {results[name]['sdpa_piece_ms']:.3f} "
            f"ms, fwd+bwd {results[name + '_bwd']['sdpa_piece_ms']:.3f} ms")
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
            library_ms=mm_ms(layer_gemms(kind, n, lq, lk, hid, pf), dev,
                             torch.bfloat16), sdpa_piece_ms=piece,
            gate=f"bf16 rel err from plain f32 {e_k:.5f} <= 2 x plain bf16 "
                 f"{e_p:.5f} + 1e-3; {ulps:.2f} bf16 ulps from plain bf16 "
                 f"<= {ULPS}")
        log(f"({phase}) {name} at {[tuple(x.shape) for x in xs]}: gate err {e_k:.5f} vs plain bf16 "
            f"{e_p:.5f}; vs plain bf16 max abs {err:.3e} = {ulps:.2f} ulps; "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{results[name]['bound_ms']:.3f} ms ({results[name]['bound_by']}"
            f"); bf16 torch.matmul of its GEMMs "
            f"{results[name]['library_ms']:.3f} ms; SDPA on its attention "
            f"piece {piece:.3f} ms")
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
    from nylon_amt_tpu_torch.tools.gemm_ab import ln_step_shapes
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
                    "decoder_layer_train_bwd": m.dec_layer - 1,
                    "ln_bwd": sum(c for _, c in ln_step_shapes(m))}
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
                    what: str = "") -> tuple[float, dict]:
    """(j): the batch-8 paper bf16 train step by CUDA events, and the
    device time per kernel over a few steps; the step's forward is the one
    the trainer routes ``cfg`` to (``step.make_apply``: the fused layers,
    or in (l) the per-site forward). Returns (ms, the launch counts of one
    step, counted before the timed ones)."""
    from nylon_amt_tpu_torch import kernels
    from nylon_amt_tpu_torch.train import step as st

    state = st.create_train_state(cfg, SEED, dev)
    batch = st.to_device(batch_np, dev)
    gen = torch.Generator().manual_seed(SEED)
    apply, draw = st.make_apply(cfg)

    def step():
        st.train_step(cfg, state, batch, draw(cfg, gen), apply)

    torch.cuda.synchronize()
    kernels.reset_launches()
    step()
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(step, iters=10, warmup=2)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"({phase}) batch-{cfg.train.batch_size} {cfg.model.compute_dtype} "
        f"{what}train step "
        f"(dropout {cfg.model.dropout}): {ms:.3f} ms by CUDA events (mean of "
        f"10 after 2), {cfg.train.batch_size / ms * 1e3:.1f} windows/s, peak "
        f"device memory {peak:.2f} GiB; card {card}")
    profile_forward(step, iters=3, phase=phase, what="train step", top=16)
    return ms, counts


Q8_SOURCES = {  # K13 wrapper -> the TPU kernel's pallas_call line
    "encoder_layer_with_stem_q8": "nylon_amt_tpu/ops/layer_fused_q8.py:329",
    "encoder_layer_q8": "nylon_amt_tpu/ops/layer_fused_q8.py:297",
    "decoder_layer_zero_q8": "nylon_amt_tpu/ops/layer_fused_q8.py:354",
    "decoder_layer_q8": "nylon_amt_tpu/ops/layer_fused_q8.py:378"}


@contextlib.contextmanager
def plain_q8_layers():
    """The int8 layer wrappers swapped for their plain versions while the
    block runs (``engine.forward`` then runs the plain q8 forward; the
    plain versions read the codes ``[K, N]`` and take no K-major pack)."""
    from nylon_amt_tpu_torch.ops import layer_fused_q8 as lq

    kept = {n: getattr(lq, n) for n in Q8_SOURCES}

    def plain_layer(plain):
        # the inputs' codes go unread; codes_out: _quant_rows of the output
        def run(*a, wt=None, codes_out=False, x_codes=None, trg_codes=None,
                enc_codes=None):
            out = plain(*a)
            return lq._with_codes(out) if codes_out else out
        return run
    try:
        for n in Q8_SOURCES:
            setattr(lq, n, plain_layer(getattr(lq, n + "_plain")))
        yield
    finally:
        for n, fn in kept.items():
            setattr(lq, n, fn)


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


# K13's CUDA kernels (csrc/layer_fused_q8.cu), each a row of the JSON line
Q8_KERNELS = ("quant_rows_kernel", "quant_cols_kernel", "gemm_q8_bias_kernel",
              "gemm_q8_res_ln_kernel", "attention_q8_kernel")
# the inputs the row quantizer still sees in a forward: the stem's output,
# the decoder's note queries and the first time layer's input (every other
# GEMM input leaves the kernel that makes it as codes)
Q8_ROW_QUANT_MAX = 3


def check_codes_handed(name, fn, xs, p8, heads, wt, got) -> None:
    """An int8 wrapper run with its inputs' row codes handed in (from the
    row quantizer) and ``codes_out``: its output bit for bit ``got``, the
    same wrapper quantizing its own inputs, and its output codes and
    scales those of ``_quant_rows`` of its output, bit for bit."""
    from nylon_amt_tpu_torch.ops import layer_fused_q8 as lq

    kw = {}
    if "stem" not in name:  # the stem layer quantizes the stem's output
        keys = (("x_codes",) if name.startswith("encoder")
                else ("trg_codes", "enc_codes"))
        kw = {key: lq.quant_rows_cuda(t.reshape(-1, t.shape[-1]))
              for key, t in zip(keys, xs)}
    out, q, sc = fn(*xs, p8, heads, wt=wt, codes_out=True, **kw)
    oq, os_ = lq._quant_rows(out)
    if not (torch.equal(out, got) and torch.equal(q, oq.reshape(q.shape))
            and torch.equal(sc, os_.reshape(-1))):
        raise AssertionError(
            f"{name}: with its inputs' codes handed in, output "
            f"{'equal' if torch.equal(out, got) else 'DIFFERS'} from the run "
            f"quantizing its own; output codes "
            f"{'equal' if torch.equal(q, oq.reshape(q.shape)) else 'DIFFER'}"
            f" from _quant_rows of the output")


def check_int8(cfg, model, packed, spec, audio, dev, card, cli_main
               ) -> tuple[dict, dict, dict]:
    """(k): K13, the int8 (W8A8) layers: the quantizers on the card bit for
    bit; each wrapper against its plain q8 version and the exact bf16
    layer; the int8 forward against the bf16 forward; ``transcribe --int8
    --list --tab --sheet --save-posteriors`` and ``evaluate`` through the
    CLI with the launch counts; times, a profile and the ``torch._int_mm``
    yardstick. Each wrapper also runs with its inputs' codes handed in and
    ``codes_out`` (check_codes_handed). Returns (launch counts of the CLI
    run, results, the profiled int8 forward's (ms, launches) of each of
    K13's CUDA kernels)."""
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
    # layer input, of a row-strided segment (the fallback of the GEMMs'
    # codes epilogue) and of an FFN-wide row; V's columns over each
    # 256-key sequence
    x = act(BATCH * n_frame * 256, 3 * hid)
    rows = {"input": x[:, :hid], "strided segment": x[:, hid:2 * hid],
            "FFN-wide": x[:, :pf]}
    for what, t in rows.items():
        q, s = lq.quant_rows_cuda(t)
        pq, ps = lq._quant_rows(t)
        if not (torch.equal(q, pq) and torch.equal(s, ps[:, 0])):
            raise AssertionError(f"K13 row quantizer ({what}) differs from "
                                 f"the plain version")
    v = x[:, 2 * hid:]
    vt, sv = lq.quant_cols_cuda(v, BATCH * n_frame)
    pv, psv = lq._quant_cols(v.reshape(BATCH * n_frame, 256, hid))
    if not (torch.equal(vt.transpose(1, 2), pv)
            and torch.equal(sv, psv[:, 0])):
        raise AssertionError("K13 column quantizer differs from the plain "
                             "version")
    q_ms = cuda_ms(lambda: lq.quant_rows_cuda(x[:, :hid]), iters=10)
    log(f"(k) K13 quantizers bit-identical to the plain versions: rows "
        f"[{x.shape[0]}, {hid}] (contiguous and row-strided) / "
        f"[{x.shape[0]}, {pf}], V columns of {BATCH * n_frame} sequences; "
        f"row quantizer {q_ms:.3f} ms at [{x.shape[0]}, {hid}]")
    del x, v, q, s, pq, ps, vt, sv, pv, psv

    # (2) each wrapper against its plain q8 version and the exact layer
    def stem(fn):
        return lambda s_, p, heads, **kw: fn(
            s_, packed.k_eff, packed.b_eff, packed.pos_freq, p, heads,
            n_frame, torch.bfloat16, **kw)

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
    wt = {  # the K-major packs of each check's int8 weights
        "encoder_layer_with_stem_q8": packed8.wt["enc"][0],
        "encoder_layer_with_stem_q8/windows": packed8.wt["enc"][0],
        "encoder_layer_q8": packed8.wt["enc"][1],
        "encoder_layer_q8/time": packed8.wt["time"][0],
        "decoder_layer_zero_q8": packed8.wt["dec_zero"],
        "decoder_layer_q8": packed8.wt["dec"][0]}
    results, failed = {}, []
    for name, (fn, plain, exact, make, p8, p16, heads) in checks.items():
        xs = make()
        got = fn(*xs, p8, heads, wt=wt[name])
        want = plain(*xs, p8, heads)
        ref = exact(*xs, p16, heads)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"{name}: non-finite output")
        check_codes_handed(name, fn, xs, p8, heads, wt[name], got)
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
        ms = cuda_ms(lambda: fn(*xs, p8, heads, wt=wt[name]))
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
        with plain_q8_layers():
            return engine.forward(packed8, spec, cfg)

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
    rows = profile_forward(lambda: engine.forward(packed8, spec, cfg),
                           phase="k", what="int8 forward", top=14)
    k13 = {k: (sum(ms for name, ms, _ in rows if f"::{k}<" in name),
               sum(c for name, _, c in rows if f"::{k}<" in name))
           for k in Q8_KERNELS}
    want_attn = m.enc_layer + 2 * m.dec_layer - 1 + m.dec_layer
    if k13["quant_rows_kernel"][1] > Q8_ROW_QUANT_MAX \
            or k13["attention_q8_kernel"][1] != want_attn:
        raise AssertionError(f"(k) the int8 forward's K13 launches {k13}: "
                             f"quant_rows_kernel at most {Q8_ROW_QUANT_MAX}, "
                             f"attention_q8_kernel {want_attn}")
    log(f"(k) K13's kernels in the profiled int8 forward: " + ", ".join(
        f"{k} {ms:.3f} ms x{c}" for k, (ms, c) in k13.items())
        + f"; every wrapper bit-identical with its inputs' codes handed in; "
        f"card {card}")

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
    return counts, results, k13


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
# Times of the mma.sync bf16 attention kernels (csrc/mha.cu before its
# products moved to wgmma fed by TMA) at the batch-32 shapes of (l) and time
# self at batch 8 (ms; (l) of the parent tree's chip_smoke.py run, NVIDIA
# H100 80GB HBM3, 700 W; PERF.md section 6)
MMA_SYNC_MS = {
    ("fused_mha", BATCH, "freq self"): 1.360,
    ("fused_mha_bwd", BATCH, "freq self"): 7.607,
    ("fused_mha_dropout", BATCH, "freq self"): 1.755,
    ("fused_mha_dropout_bwd", BATCH, "freq self"): 9.551,
    ("fused_mha", BATCH, "cross"): 0.726,
    ("fused_mha_bwd", BATCH, "cross"): 3.403,
    ("fused_mha_dropout", BATCH, "cross"): 0.941,
    ("fused_mha_dropout_bwd", BATCH, "cross"): 4.026,
    ("fused_mha", BATCH, "note self"): 0.323,
    ("fused_mha_bwd", BATCH, "note self"): 1.792,
    ("fused_mha_dropout", BATCH, "note self"): 0.463,
    ("fused_mha_dropout_bwd", BATCH, "note self"): 2.099,
    ("fused_mha", TRAIN_BATCH, "time self"): 0.102,
    ("fused_mha_bwd", TRAIN_BATCH, "time self"): 0.771}
# the bf16 attention kernels of csrc/mha.cu and their instantiations: D 32
# and 64 x key tiers 96, 128, 256 x (forward plain, K11, dropout; backward
# plain, dropout)
MHA_KERNELS = ("attn_fwd_kernel", "attn_bwd_kernel")
MHA_INSTANTIATIONS = 2 * 3 * (3 + 2)
# the f32 attention kernels of csrc/mha_f32.cu and their instantiations: the
# forward at D 32 and 64 (plain, K11, dropout), its FFMA-score form (plain,
# dropout), the backward and its FFMA-score form at D 32 and 64 x key tiers
# 96, 128, 256 (plain, dropout)
MHA_F32_KERNELS = ("attn_fwd_f32_kernel", "attn_fwd_ffma_f32_kernel",
                   "attn_bwd_f32_kernel", "attn_bwd_ffma_f32_kernel")
MHA_F32_INSTANTIATIONS = 2 * (3 + 2) + 2 * (2 * 3 * 2)
# Times of csrc/mha_f32.cu's mma.sync kernels (3xTF32 products on
# mma.sync m16n8k8 fed by cp.async, the forward's scores on FFMA) that the
# wgmma / TMA kernels replaced, at (n.1)'s row shapes per head_dim (ms,
# CUDA events around the wrappers: the parent tree's chip_smoke.py (n.1);
# PERF.md section 6: NVIDIA H100 80GB HBM3, 700 W)
MMA_F32_MS = {
    ("fused_mha", 32): 2.333, ("fused_mha_bwd", 32): 1.727,
    ("fused_mha_with_probs", 32): 1.230,
    ("fused_mha_with_probs_bwd", 32): 0.623,
    ("fused_mha_dropout", 32): 0.864, ("fused_mha_dropout_bwd", 32): 6.041,
    ("fused_mha", 64): 7.731, ("fused_mha_bwd", 64): 5.260,
    ("fused_mha_with_probs", 64): 4.341,
    ("fused_mha_with_probs_bwd", 64): 1.948,
    ("fused_mha_dropout", 64): 2.422, ("fused_mha_dropout_bwd", 64): 5.402}
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


def mha_bound(name: str, n: int, lq: int, lk: int, heads: int,
              d: int) -> dict:
    """bound() of a K10-K12 wrapper at [n, lq, lk] x heads of d: q, k, v
    (and dO) read once, the output (and K11's f32 probabilities; dq, dk,
    dv) written once; its products (2, or the backward's 5 at the least) on
    the bf16 tensor cores, the hash of each score under dropout (8 integer
    operations) on the CUDA cores."""
    hid = heads * d
    if name.endswith("_bwd"):
        nb, products = 2 * n * hid * (3 * lq + 4 * lk), 5
    else:
        nb, products = 2 * n * hid * (2 * lq + 2 * lk), 2
        if name == "fused_mha_with_probs":
            nb += 4 * n * heads * lq * lk
    hash_ops = 8 * n * heads * lq * lk if "dropout" in name else 0
    return bound(nb, 2 * products * n * heads * lq * lk * d,
                 f32_flops=hash_ops)


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
                f"{k_} {v_:.3f} (bound "
                f"{mha_bound(k_, n, lq, lk, heads, d)['bound_ms']:.3f})"
                + (f" (SDPA {lib[k_]:.3f})" if lib[k_] is not None else "")
                + (f" (mma.sync {MMA_SYNC_MS[k_, B, site]:.3f}: "
                   f"{MMA_SYNC_MS[k_, B, site] / v_:.2f}x)"
                   if d == 64 and (k_, B, site) in MMA_SYNC_MS else "")
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
                else:
                    plain_ms = cuda_ms(lambda: att.mha_plain(
                        q, k, v, heads, scale, msk,
                        with_probs=name == "fused_mha_with_probs"), iters=1)
                rows[name] = dict(
                    max_abs_err=fields[name]["max_abs_err"], ms=ms[name],
                    plain_ms=plain_ms,
                    **mha_bound(name, n, lq, lk, heads, d),
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

@contextlib.contextmanager
def plain_stage1_tokens():
    """Records (under "trg") the stage-1 tokens that a plain HFT forward in
    the block hands its stage 2 (``models.hft.stage2``)."""
    from nylon_amt_tpu_torch.models import hft

    seen, stage2 = {}, hft.stage2

    def record(dec, trg, *rest):
        seen["trg"] = trg
        return stage2(dec, trg, *rest)

    hft.stage2 = record
    try:
        yield seen
    finally:
        hft.stage2 = stage2


def check_engine_bf16(cfg, model, model32, packed, spec, dev, card,
                      label: str, phase: str = "m",
                      b_end_to_end: bool = True) -> None:
    """(m.3): the engine's batch-32 bf16 forward of ``cfg`` (``packed`` of
    ``model``) against the plain bf16 forward under (e)'s gates (the
    float32 ``model32`` the truth), with its launch counts, times and
    profile; and stage by stage, as (h)'s stage hook feeds each kernel its
    twin's intermediates: the engine's stage 2 (``engine.stage2``: the time
    layers and the B heads) fed the plain forward's own stage-1 tokens, its
    B heads within ULPS_FORWARD["B"] ulps of the plain forward's (the
    stage-1 tokens are held by the A heads). ``b_end_to_end`` False: the B
    heads' end-to-end ulps are printed beside those, not held (the hid-96
    call: see there)."""
    from nylon_amt_tpu_torch import kernels
    from nylon_amt_tpu_torch.infer import engine
    from nylon_amt_tpu_torch.ops.precision import full_f32

    m = cfg.model
    torch.cuda.synchronize()
    kernels.reset_launches()
    got = engine.forward(packed, spec, cfg)
    torch.cuda.synchronize()
    f_counts = {k: v for k, v in kernels.launches.items() if v}
    want = {"encoder_layer_with_stem": 1,
            "encoder_layer": m.enc_layer - 1 + m.dec_layer,
            "decoder_layer_zero": 1, "decoder_layer": m.dec_layer - 1}
    if f_counts != want:
        raise AssertionError(f"({phase}) engine forward launches {f_counts}, "
                             f"expected {want}")
    with torch.no_grad():
        with plain_stage1_tokens() as seen:
            plain16 = model(spec)
        staged = engine.stage2(packed, seen["trg"], spec.shape[0], cfg)
        with full_f32():
            truth = model32(spec)
    failed, line = [], []
    limit = ULPS_FORWARD["B"]
    for k in truth:
        try:
            e_k, e_p = bf16_gate(f"({phase}) engine {k}", got[k], plain16[k],
                                 truth[k])
        except AssertionError as e:
            failed.append(str(e))
            e_k = e_p = float("nan")
        _, ulps = ulp_distance(got[k], plain16[k])
        stage_txt = ""
        if k.endswith("_B"):
            st = staged[k] if k.startswith("velocity") else staged[k][..., 0]
            _, s_ulps = ulp_distance(st, plain16[k])
            if not s_ulps <= limit:
                failed.append(f"({phase}) engine stage 2 {k} on the plain "
                              f"stage-1 tokens: {s_ulps:.1f} ulps from plain "
                              f"bf16 > {limit}")
            stage_txt = f", stage 2 on the plain tokens {s_ulps:.1f}"
        over = not ulps <= ULPS_FORWARD[k[-1]]
        if over and (b_end_to_end or k.endswith("_A")):
            failed.append(f"({phase}) engine {k}: {ulps:.1f} ulps from plain "
                          f"bf16 > {ULPS_FORWARD[k[-1]]}")
        line.append(f"{k} {ulps:.1f} ulps{' (past, not held)' if over else ''}"
                    f"{stage_txt} (gate {e_k:.4f}/{e_p:.4f})")
    log(f"({phase}) batch-{BATCH} {label}: engine vs plain bf16 (<= 8 / 64 "
        f"ulps{'' if b_end_to_end else ', B heads end to end not held'}; "
        f"B heads' stage 2 on the plain stage-1 tokens <= {limit}): "
        + ", ".join(line))
    if failed:
        raise AssertionError("; ".join(failed))
    del staged, seen
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: engine.forward(packed, spec, cfg), iters=10)
        plain_ms = cuda_ms(lambda: model(spec), iters=3)
    audio_s = BATCH * cfg.input.num_frame * cfg.feature.hop_sample / SR
    log(f"({phase}) batch-{BATCH} {label}: engine {fwd_ms:.3f} ms "
        f"({audio_s / fwd_ms * 1e3:.1f} audio-s/s), plain {plain_ms:.3f} ms; "
        f"launches {f_counts}; card {card}")
    profile_forward(lambda: engine.forward(packed, spec, cfg), iters=5,
                    phase=phase, top=6)
    del truth, plain16, got


def check_default_config(feat, audio, spec, dev, card, cli_main) -> None:
    """(m): the default ``ModelConfig()`` (hid 64, 2 + 2 heads, so head_dim
    32; pf 128, dropout 0.1) in bf16 on the card: (m.1) the D = 32
    attention kernels at the four site geometries under (l)'s gates; (m.2)
    K2-K5 at batch 32 under (c)'s gates and K7-K9 forward and backward at
    batch 8 under (h)'s, with the chained input grads bounded by the plain
    twin's own distance from the f32 truth (widths that are not multiples
    of 128 take the partial tiles of the weight-gradient kernel); (m.3) the
    engine's batch-32 forward against the plain bf16 forward under (e)'s
    gates, its stage 2 also on the plain stage-1 tokens; (m.4) ``cli train`` (3 steps of 16, the fused trainer), ``cli
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
    check_engine_bf16(cfg, model, model32, packed, spec, dev, card,
                      f"default-config bf16 forward (hid {m.hid_dim}, "
                      f"{heads} heads of 32)", phase="m")

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
    # times at (l)'s row shapes by CUDA graphs of the kernel's call (no host
    # time in them), beside f32 SDPA on the same inputs (CUDA events)
    from nylon_amt_tpu_torch.tools.gemm_ab import graph_ms

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
                ms = graph_ms(lambda: att._bwd_cuda(q, k, v, do, heads, scale,
                                                    rate, DROP_SEED))
                lib = _bwd_only_ms(sd, q, k, v, do)
                plain_ms = cuda_ms(lambda: att.mha_bwd_plain(
                    q, k, v, do, heads, scale, msk), iters=1)
                nb, products = nbytes(q, k, v, do, q, k, v), 5
            else:
                ms = graph_ms(lambda: att._fwd_cuda(
                    q, k, v, heads, scale, rate, DROP_SEED,
                    with_probs=base == "fused_mha_with_probs"))
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
        # as the products run (every product as 3xTF32; K11 also a second
        # pass of its scores on FFMA), all as 3xTF32, all on FFMA
        ffma = bound(nb, f32_flops=flops + hash_ops)
        tf32 = bound(nb, f32_flops=hash_ops, tf32x3_flops=flops)
        run = bound(nb, f32_flops=flops / 2 + hash_ops, tf32x3_flops=flops) \
            if base == "fused_mha_with_probs" and name == base else tf32
        times[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib,
                           shape=[n, lq, lk], **run)
        log(f"(n.1) f32 {name} [{n}, {lq}, {lk}] D{d}: kernel {ms:.3f} ms "
            f"by CUDA graphs (mma.sync kernel {MMA_F32_MS[name, d]:.3f}, "
            f"all-FFMA kernel {FFMA_F32_MS[name, d]:.3f}, by events), plain "
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
    real windows ``spec``; the engine's TF32 pairs of ``packed``) against
    their plain f32 versions, within F32_OUT_REL, with the kernel's and
    the plain version's distances from a float64 truth (``layer64``; K2's
    from the plain stem's output); times beside the plain version, an f32
    ``torch.matmul`` of the layer's GEMMs and the bound. Returns the
    times."""
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
        return lambda s, p, heads, **kw: fn(s, packed.k_eff, packed.b_eff,
                                            packed.pos_freq, p, heads,
                                            n_frame, torch.float32, **kw)

    spec_t = spec.transpose(1, 2).contiguous()
    pairs = packed.tf32
    checks = {  # kernel, plain, inputs, params, TF32 pairs, heads, (kind,
        # n, lq, lk)
        "encoder_layer_with_stem": (
            stem(lf.encoder_layer_with_stem),
            stem(lf.encoder_layer_with_stem_plain), lambda: (spec_t,),
            packed.enc[0], pairs["enc"][0], m.enc_head,
            ("enc", n_f, 256, 256)),
        "encoder_layer": (lf.encoder_layer, lf.encoder_layer_plain,
                          lambda: (act(n_f, 256, hid),), packed.enc[1],
                          pairs["enc"][1], m.enc_head, ("enc", n_f, 256, 256)),
        "encoder_layer/time": (lf.encoder_layer, lf.encoder_layer_plain,
                               lambda: (act(n_t, n_frame, hid),),
                               packed.time[0], pairs["time"][0], m.dec_head,
                               ("enc", n_t, n_frame, n_frame)),
        "decoder_layer_zero": (lf.decoder_layer_zero,
                               lf.decoder_layer_zero_plain,
                               lambda: (act(n_f, 88, hid),
                                        act(n_f, 256, hid)),
                               packed.dec_zero, pairs["dec_zero"], m.dec_head,
                               ("dec_zero", n_f, 88, 256)),
        "decoder_layer": (lf.decoder_layer, lf.decoder_layer_plain,
                          lambda: (act(n_f, 88, hid), act(n_f, 256, hid)),
                          packed.dec[0], pairs["dec"][0], m.dec_head,
                          ("dec", n_f, 88, 256))}
    results = {}
    for name in names:
        fn, plain, make, p, tf32, heads, (kind, n, lq, lk) = checks[name]
        xs = make()
        got = fn(*xs, p, heads, tf32=tf32)
        with full_f32():
            want = plain(*xs, p, heads)
            # the float64 truth of the layer (K2's from the plain stem)
            x64 = ((lf.stem_embed_plain(spec_t, packed.k_eff, packed.b_eff,
                                        packed.pos_freq, n_frame,
                                        torch.float32),)
                   if "stem" in name else xs)
        truth = layer64(kind, x64, p, heads)
        e = rel_err(got, want, 1.0)
        e64, p64 = f64_dist(got, truth), f64_dist(want, truth)
        if not (got.dtype == torch.float32 and e <= F32_OUT_REL):
            raise AssertionError(f"(n) f32 {name} {tag}: {got.dtype}, "
                                 f"{e:.2e} of max(1, |plain f32|) > "
                                 f"{F32_OUT_REL}; from float64 kernel "
                                 f"{e64:.2e}, plain f32 {p64:.2e}")
        held(name, torch.float32, hid // heads)
        del want, truth, x64
        ms = cuda_ms(lambda: fn(*xs, p, heads, tf32=tf32))
        with full_f32():
            plain_ms = cuda_ms(lambda: plain(*xs, p, heads), iters=2)
        stem_flops = 2 * n * 256 * n_proc * hid if "stem" in name else 0
        weights = [t for t in p if t.numel()]
        if stem_flops:
            weights += [packed.k_eff, packed.b_eff, packed.pos_freq]
        flops = layer_flops(kind, n, lq, lk, hid, pf) + stem_flops
        # priced as the products run: the stem, the stem layer's QKV and
        # the attention scores on FFMA; the other GEMMs and the PV 3xTF32
        ffma = (stem_flops + attn_product_flops(kind, n, lq, lk, hid)
                + (2 * n * lq * hid * 3 * hid if stem_flops else 0))
        lib = mm_ms(layer_gemms(kind, n, lq, lk, hid, pf), dev)
        results[name] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms,
                             library_ms=lib, shape=[n, lq, lk, hid],
                             f64_dist=e64, plain_f64_dist=p64,
                             **bound(nbytes(*xs, *weights, got),
                                     f32_flops=ffma,
                                     tf32x3_flops=flops - ffma))
        log(f"(n.2) f32 {name} {tag} at {[tuple(x.shape) for x in xs]}: "
            f"{e:.2e} of max(1, |plain f32|) (<= {F32_OUT_REL}); from "
            f"float64 kernel {e64:.2e}, plain f32 {p64:.2e}; kernel "
            f"{ms:.3f} ms, plain f32 {plain_ms:.3f} ms, f32 matmul of its "
            f"GEMMs {lib:.3f} ms, bound {results[name]['bound_ms']:.3f} ms "
            f"({results[name]['bound_by']})")
        del xs, got
        torch.cuda.empty_cache()
    return results


def _stem_input(model, spec):
    """The f32 training forward's input to its first layer
    (``models/fused_train.py::train_forward``): the stem's output on the
    first TRAIN_BATCH real windows ``spec``, scaled, plus the position
    embedding."""
    from nylon_amt_tpu_torch.ops.layer_fused import fused_stem, sqrt_hid

    cfg, enc = model.config, model.encoder_spec2midi
    n_frame, hid = cfg.input.num_frame, cfg.model.hid_dim
    with torch.no_grad():
        k_eff, b_eff = enc.stem_kernel(cfg)
        emb = fused_stem(spec[:TRAIN_BATCH], k_eff, b_eff, torch.float32)
        x = (emb.reshape(TRAIN_BATCH * n_frame, -1, hid)
             * sqrt_hid(hid, torch.float32).to(spec.device)
             + enc.pos_embedding_freq.weight.float())
    return x.contiguous()


def check_train_layers_f32(model, cfg, spec, dev, names,
                           tag: str) -> dict:
    """(n.2): K7, K8, K9 in f32 forward and backward at the batch-8 shapes
    of ``cfg`` against their plain f32 twins: the forward within
    F32_OUT_REL, input and weight gradients within F32_GRAD_REL,
    bit-identical backward runs, and (h)'s stage hook: every backward
    kernel fed the twin's own intermediates within F32_STAGE_REL of the
    twin's same stage, its weight gradients within STAGE_WGRAD_REL.
    "encoder_layer_train/stem" is K7 as training runs it on the stem's
    output of the real windows ``spec`` (its QKV on FFMA, its attention
    backward's scores on FFMA); at rate 0 it is also held
    within F32_OUT_REL of the plain twin, with both distances from the
    float64 layer printed; its gradients are held against a float64 truth
    of the twin instead (within twice the twin's own distance + 1e-6, as
    (p) holds dW), and its stage hook over every stage, the attention
    backward's (printed on its own) included. Returns the times, and under
    "<name>/bwd_gemm_launches" the dX and dW launches of one backward."""
    from nylon_amt_tpu_torch import kernels
    from nylon_amt_tpu_torch.ops.precision import full_f32

    m = cfg.model
    hid, pf = m.hid_dim, m.pf_dim
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    layers = _train_layers(model, dev, torch.float32)
    _, _, p0, _ = layers["encoder_layer_train"]
    layers["encoder_layer_train/stem"] = ("enc", (_stem_input(model, spec),),
                                          p0, True)
    results = {}
    for name in names:
        kind, xs, p, emb = layers[name]
        stem = name.endswith("/stem")
        heads = m.enc_head if kind == "enc" else m.dec_head
        k_fwd, p_fwd, k_bwd, p_bwd = _layer_fns(kind, emb, heads, stem)
        n, lq, _ = xs[0].shape
        lk = xs[-1].shape[1]
        zero64 = ""
        if stem:  # rate 0: the inference layer's function, and its truth
            got, want = k_fwd(xs, p, 0.0), p_fwd(xs, p, 0.0)
            e0 = rel_err(got, want, 1.0)
            with full_f32():
                truth = layer64(kind, xs, p, heads)
            e64, p64 = f64_dist(got, truth), f64_dist(want, truth)
            if not e0 <= F32_OUT_REL:
                raise AssertionError(
                    f"(n) f32 {name} {tag} rate 0: {e0:.2e} of max(1, "
                    f"|plain f32|) > {F32_OUT_REL}; from float64 kernel "
                    f"{e64:.2e}, plain f32 {p64:.2e}")
            results[name + "/rate0"] = dict(max_abs_err=e0, f64_dist=e64,
                                            plain_f64_dist=p64)
            zero64 = (f"; rate 0: {e0:.2e} of max(1, |plain f32|), from "
                      f"float64 kernel {e64:.2e}, plain f32 {p64:.2e}")
            del got, want, truth
        got = k_fwd(xs, p, RATE)
        want = p_fwd(xs, p, RATE)
        e = rel_err(got, want, 1.0)
        dz = torch.randn(xs[0].shape, generator=g, device=dev)
        own = {}   # the kernels' own FFN activations, by a pass-through hook

        def record(stage, t):
            if stage.endswith("midd"):
                own[stage] = t
            return t

        kernels.reset_launches()
        kb = k_bwd(xs, p, RATE, dz, record)
        results[name + "/bwd_gemm_launches"] = {
            k: kernels.launches[k] for k in ("gemm_nt_f32", "wgrad_f32")}
        kb2 = k_bwd(xs, p, RATE, dz)
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
        grads_held = e_in <= F32_GRAD_REL and (n_flips > 0
                                               or e_w <= F32_GRAD_REL)
        if stem:
            # On the stem's output (scores near 2^14) the gradients are
            # held against a float64 truth of the plain twin, as (p) holds
            # dW: the kernels' distance within twice the plain f32 twin's
            # own + 1e-6, input grads on the sequences with no flip
            with full_f32():
                t_in, t_w = _split_bwd(kind, p_bwd(
                    [x.double() for x in xs],
                    type(p)(*(t.double() for t in p)), RATE, dz.double()))
            d64 = {}
            for label, got_, plain_, truth_ in (
                    ("input", k_in, p_in, t_in), ("weight", k_w, p_w, t_w)):
                sel = ((lambda t: t[clean]) if label == "input"
                       else (lambda t: t))
                d64[label] = [max(rel_err(sel(a), sel(t)) for a, t in
                                  zip(got_, truth_)),
                              max(rel_err(sel(a), sel(t)) for a, t in
                                  zip(plain_, truth_))]
            grads_held = all(k64 <= 2 * p64_ + 1e-6
                             for k64, p64_ in d64.values())
            zero64 += ("; grads from float64 (kernel, plain f32): "
                       + ", ".join(f"{k} {a:.2e}, {b:.2e}"
                                   for k, (a, b) in d64.items()))
            results[name + "/grads64"] = {
                f"{k}_{w}": v for k, (a, b) in d64.items()
                for w, v in (("f64_dist", a), ("plain_f64_dist", b))}
            del t_in, t_w
        if not (e <= F32_OUT_REL and grads_held and near <= near_limit):
            raise AssertionError(
                f"(n) f32 {name} {tag}: fwd {e:.2e} (<= {F32_OUT_REL}), "
                f"input grads {e_in:.2e} on the {int(clean.sum())} of {n} "
                f"sequences with no ReLU gate flip, weight grads {e_w:.2e} "
                f"(<= {F32_GRAD_REL} when nothing flipped) from the plain "
                f"f32 twin; {n_flips} flips, within {near:.2e} of 0 (<= "
                f"{near_limit:.2e}){zero64}")
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
        if stem:
            # the f32 attention backward on the stem's scores (near 2^14),
            # which it recomputes on FFMA as the forward computes them
            zero64 += (f"; attention backward on the twin's inputs "
                       f"{stage['dqkv']:.2e} from the twin's dqkv (<= "
                       f"{F32_STAGE_REL})")
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
        # a = one attention product. The forward: its GEMMs and PV as
        # 3xTF32, its scores on FFMA. The backward recomputes the forward
        # and adds 5 attention products and the GEMMs' dX and dW (all
        # 3xTF32). The layer the stem feeds has its QKV on FFMA, forward and
        # recompute, and its backward's S^T on FFMA.
        a = attn_product_flops(kind, n, lq, lk, hid)
        gemm = flops - 2 * a
        qkv = 2 * n * lq * hid * 3 * hid if stem else 0
        s_ffma = a if stem else 0
        w_bytes, io_bytes = nbytes(*p), nbytes(*xs)
        gemms = layer_gemms(kind, n, lq, lk, hid, pf)
        results[name] = dict(
            max_abs_err=e, ms=fwd_ms, plain_ms=fwd_plain_ms,
            library_ms=mm_ms(gemms, dev), shape=[n, lq, lk, hid],
            **bound(io_bytes + w_bytes + nbytes(got), f32_flops=a + qkv,
                    tf32x3_flops=gemm - qkv + a))
        results[bwd_name(name)] = dict(
            max_abs_err=e_in, ms=bwd_ms, plain_ms=bwd_plain_ms,
            library_ms=mm_ms(gemms * 3, dev), shape=[n, lq, lk, hid],
            **bound(2 * io_bytes + nbytes(dz) + 2 * w_bytes,
                    f32_flops=a + s_ffma + qkv,
                    tf32x3_flops=3 * gemm - qkv + 6 * a - s_ffma))
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
            f"{results[bwd_name(name)]['bound_ms']:.3f}){zero64}")
        del xs, got, kb, k_in, k_w, dz
        torch.cuda.empty_cache()
    return results


def check_int8_d32(model16, model32, cfg, spec, dev, tag: str = "") -> dict:
    """(n.3): K13 at head_dim 32 (the default widths), in bf16 and in f32:
    the quantizers bit for bit; each wrapper at the batch-32 shapes against
    its plain q8 version and the exact layer, under (k)'s gates (bf16) or
    their f32 analogue (Q8_F32_REL, Q8_F32_EXACT), and bit for bit with its
    inputs' codes handed in (check_codes_handed); the stem layer also as
    ``check_q8_stem`` holds it. ``model16`` None: f32 only (the paper
    widths, head_dim 64; ``tag`` "/paper" on the keys). Returns the f32 and
    bf16 times."""
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
        for t in (x[:, :hid], x[:, hid:2 * hid], x[:, :pf]):
            q, s = lq.quant_rows_cuda(t)
            pq, ps = lq._quant_rows(t)
            if not (torch.equal(q, pq) and torch.equal(s, ps[:, 0])):
                raise AssertionError(f"(n) {label} row quantizer at width "
                                     f"{t.shape[1]} (row stride "
                                     f"{t.stride(0)}) differs")
        v = x[:, 2 * hid:]
        vt, sv = lq.quant_cols_cuda(v, n_f)
        pv, psv = lq._quant_cols(v.reshape(n_f, 256, hid))
        if not (torch.equal(vt.transpose(1, 2), pv)
                and torch.equal(sv, psv[:, 0])):
            raise AssertionError(f"(n) {label} column quantizer differs")
        del x, v, q, s, vt, sv, pv, psv

        def stem(fn, dt=dt, packed=packed):
            return lambda s_, p, heads, **kw: fn(
                s_, packed.k_eff, packed.b_eff, packed.pos_freq, p, heads,
                n_frame, dt, **kw)

        def by_check(packs):
            """A pack's entries for the checks below, by name."""
            return {"encoder_layer_with_stem_q8": packs["enc"][0],
                    "encoder_layer_q8": packs["enc"][1],
                    "encoder_layer_q8/time": packs["time"][0],
                    "decoder_layer_zero_q8": packs["dec_zero"],
                    "decoder_layer_q8": packs["dec"][0]}

        # float32: the TF32 pairs the exact layers read
        exact_kw = {} if packed.tf32 is None else {
            name: {"tf32": tf32} for name, tf32 in by_check(
                packed.tf32).items()}
        wt = by_check(packed8.wt)  # the K-major packs the int8 kernels read

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
            got = fn(*xs, p8, heads, wt=wt[name])
            with full_f32():
                want = plain(*xs, p8, heads)
            ref = exact(*xs, p, heads, **exact_kw.get(name, {}))
            torch.cuda.synchronize()
            if got.dtype != dt or not torch.isfinite(got.float()).all():
                raise AssertionError(f"(n) {label} {name}: {got.dtype}, or "
                                     f"not finite")
            check_codes_handed(name, fn, xs, p8, heads, wt[name], got)
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
            del d, ref
            budget, stem_txt = Q8_BUDGET, ""
            if "stem" in name:
                budget, stem_txt = check_q8_stem(packed, p8, heads, n_frame,
                                                 spec_t, wt[name], want, dt)
            if not (share >= Q8_SHARE and err <= budget
                    and from_exact <= plain_exact + extra):
                raise AssertionError(
                    f"(n) {label} {name} D{hid // heads}: {share:.6f} within "
                    f"{tol:.2e} of the plain q8 version (>= {Q8_SHARE}), max "
                    f"{err:.4f} (<= {budget:.4f}); {from_exact:.4f} from the "
                    f"exact layer (<= {plain_exact:.4f} + {extra:.2e})")
            held(name, dt, hid // heads)
            del want
            ms = cuda_ms(lambda: fn(*xs, p8, heads, wt=wt[name]))
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
                        f"{Q8_F32_REL} of max) / max {err:.2e}{stem_txt} / "
                        f"exact {from_exact:.4f} (plain q8 "
                        f"{plain_exact:.4f}); "
                        f"{ms:.3f} ms (plain q8 {plain_ms:.3f}, _int_mm "
                        f"{results[f'{name}/{label}{tag}']['library_ms']:.3f})")
            del got
        if dt == torch.float32:
            line.insert(0, check_q8_kernels_f32(packed8, hid, m.enc_head,
                                                pf, dev, g))
        log(f"(n.3) K13 {label} at hid {hid} over {m.enc_head} heads "
            f"(quantizers bit-identical, every wrapper with its inputs' "
            f"codes handed in bit-identical): " + "; ".join(line))
        del packed, packed8
        torch.cuda.empty_cache()
    return results


def check_q8_stem(packed, p8, heads: int, n_frame: int, spec_t, wt, want,
                  dt) -> tuple[float, str]:
    """(n.3): the int8 stem layer piece by piece, on the stem's two
    outputs: K2's stem kernel alone against ``stem_embed_plain`` (bf16
    within ULPS ulps, f32 within F32_OUT_REL of max(1, max |plain|)); the
    int8 layer after it, fed the plain stem's output, within (k)'s gates of
    the plain q8 stem layer ``want`` (>= Q8_SHARE within ULPS bf16 ulps of
    max |want|, all within Q8_BUDGET); and the plain q8 layer fed the stem
    kernel's output, whose distance from ``want`` is the plain version's
    own reach. The stem kernel's f32 sums run in another order than the
    plain convolution's (~1e-7 of max), and a row code flipped at a rounding
    boundary by that can move a row of the plain q8 layer past Q8_BUDGET
    by itself (its attention scores reach ~2^14: a near tie picks another
    key). So the whole layer's max is held to Q8_BUDGET or, where the plain
    q8 layer's own reach exceeds it, to Q8_FORWARD_REL x that reach, as
    (k)'s A heads take the B heads' rule where the scheme itself lands past
    Q8_POST. Returns (that limit, log text)."""
    from nylon_amt_tpu_torch.ops import layer_fused as lf
    from nylon_amt_tpu_torch.ops import layer_fused_q8 as lq
    from nylon_amt_tpu_torch.ops.precision import full_f32

    args = (spec_t, packed.k_eff, packed.b_eff, packed.pos_freq, n_frame, dt)
    x_k, x_p = lf._stem_embed(*args), lf.stem_embed_plain(*args)
    torch.cuda.synchronize()
    same = torch.equal(x_k, x_p)
    s_err = (x_k.float() - x_p.float()).abs().max().item()
    if dt == torch.bfloat16:
        s_ok, s_txt = s_err / bf16_ulp(x_p) <= ULPS, \
            f"{s_err / bf16_ulp(x_p):.2f} ulps"
    else:
        s_rel = s_err / max(1.0, x_p.abs().max().item())
        s_ok, s_txt = s_rel <= F32_OUT_REL, f"{s_rel:.2e} of max"
    d = (lq.encoder_layer_q8(x_p, p8, heads, wt=wt).float()
         - want.float()).abs()
    share = (d <= ULPS * bf16_ulp(want)).float().mean().item()
    err = d.max().item()
    del x_p, d
    reach = 0.0  # the plain layer on the plain stem's own output is want
    if not same:
        torch.cuda.empty_cache()
        with full_f32():
            reach = (lq.encoder_layer_q8_plain(x_k, p8, heads).float()
                     - want.float()).abs().max().item()
    if not (s_ok and share >= Q8_SHARE and err <= Q8_BUDGET):
        raise AssertionError(
            f"(n.3) int8 stem layer at hid {x_p.shape[-1]}, {dt}: stem "
            f"kernel {s_txt} from stem_embed_plain; the int8 layer on the "
            f"plain stem's output {share:.6f} within {ULPS} ulps (>= "
            f"{Q8_SHARE}), max {err:.4f} (<= {Q8_BUDGET})")
    limit = Q8_BUDGET if reach <= Q8_BUDGET else Q8_FORWARD_REL * reach
    del x_k
    return limit, (f" (stem kernel {s_txt} from plain; int8 layer on the "
                   f"plain stem's output {share:.6f} / max {err:.2e}; plain "
                   f"q8 layer on the stem kernel's output {reach:.4f} from "
                   f"plain, so max <= {limit:.4f})")


def check_q8_kernels_f32(packed8, hid: int, heads: int, pf: int, dev,
                         g) -> str:
    """(n.3): K13's f32 kernels one by one at the batch-32 encoder shapes,
    each fed the plain version's own codes and intermediates (see
    Q8_F32_REL). Returns the log text."""
    from nylon_amt_tpu_torch.ops import layer_fused_q8 as lq
    from nylon_amt_tpu_torch.ops.layer_fused import _layer_norm, _scale
    from nylon_amt_tpu_torch.ops.precision import full_f32

    p, wt = packed8.enc[1], packed8.wt["enc"][1]
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
            "qkv": (lq._gemm_q8(xq, sx, p.wqkv, p.sqkv, p.bqkv,
                                wt=wt["wqkv"]),
                    lq._qlinear_pre(xq, sx2, p.wqkv, p.sqkv, p.bqkv, f32)),
            "ffn up + ReLU": (
                lq._gemm_q8(xq, sx, p.w1, p.s1, p.b1, relu=True,
                            wt=wt["w1"]),
                torch.relu(lq._qlinear_pre(xq, sx2, p.w1, p.s1, p.b1, f32)))}
        y, yq, sy = lq._gemm_q8_res_ln(mq, sm, p.w2, p.s2, p.b2, x, p.g, p.b,
                                       quant_out=True, wt=wt["w2"])
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
    got, codes, scales = lq._attention_q8(qq, sq, kq, sk, vt, sv, n, heads,
                                          f32, t_out=True)
    oq, os_ = lq._quant_rows(got)
    if not (torch.equal(codes, oq) and torch.equal(scales, os_[:, 0])):
        raise AssertionError("(n) f32 K13 attention: its codes or scales "
                             "differ from _quant_rows of its own output")
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


def f32_gemm_launches(m, train: bool = False) -> dict:
    """Launches of the float32 GEMM kernels (``kernels.launches``
    "gemm_bias_f32", "gemm_res_ln_f32", and "gemm_bias_ffma_f32": the stem
    layer's QKV) in one engine forward of the model config ``m`` (stage 2
    on), or with ``train`` in one fused train step (each layer's forward
    and its backward's recompute, and the backward's dX and dW GEMMs:
    "gemm_nt_f32", "wgrad_f32", 4 a K7 layer, 5 for K8, 7 a K9 layer)."""
    enc, dec = m.enc_layer, m.dec_layer
    if train:
        layers = enc + dec                          # K7: frequency + time
        bwd = 4 * layers + 5 + 7 * (dec - 1)
        return {"gemm_bias_f32": 2 * (2 * layers - 1 + 3 + 4 * (dec - 1)),
                "gemm_res_ln_f32": 2 * (2 * layers + 2 + 3 * (dec - 1)),
                "gemm_bias_ffma_f32": 2, "gemm_nt_f32": bwd,
                "wgrad_f32": bwd}
    return {"gemm_bias_f32": 1 + 2 * (enc - 1) + 3 + 4 * (dec - 1) + 2 * dec,
            "gemm_res_ln_f32": 2 + 2 * (enc - 1) + 2 + 3 * (dec - 1)
            + 2 * dec, "gemm_bias_ffma_f32": 1}


def check_forward_f32(cfg, model32, spec, dev, card, tag: str,
                      with_int8: bool) -> dict:
    """(n.4): the engine's batch-32 forward of ``cfg`` (float32) against
    the plain f32 forward, per output key, within F32_FORWARD_REL of max(1,
    max |plain|); with ``with_int8`` also the int8 forward under (k)'s
    posterior gates against the f32 forward. Returns the times and the
    f32 forward's launch counts."""
    from nylon_amt_tpu_torch import kernels
    from nylon_amt_tpu_torch.infer import engine
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
                   "decoder_layer_zero": 1, "decoder_layer": m.dec_layer - 1,
                   **f32_gemm_launches(m)}
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
    out = {"ms": ms, "plain_ms": plain_ms, "launches": counts}
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
            with plain_q8_layers(), full_f32():
                return engine.forward(packed8, spec, cfg)

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
        # the f32 GEMMs: the steps', and the validation forwards' (the
        # engine's, one stem layer each)
        n_valid = counts["encoder_layer_with_stem"]
        for k, v in f32_gemm_launches(m, train=True).items():
            want[k] = steps * v + n_valid * f32_gemm_launches(m).get(k, 0)
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
            if label == "exact":
                t_want.update({k: n_batches * v for k, v in
                               f32_gemm_launches(m).items()})
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


def time_train_step_f32(cfg, feat, dev, card: str) -> tuple[float, dict]:
    """(n): the default fused train step (float32, batch 8) by CUDA
    events, and its profile; and the float32 GEMM launches of one step,
    which must be f32_gemm_launches(train=True)'s."""
    from nylon_amt_tpu_torch import kernels
    from nylon_amt_tpu_torch.data.corpus import SplitArrays
    from nylon_amt_tpu_torch.data.windows import WindowDataset
    from nylon_amt_tpu_torch.tools.gemm_ab import ln_step_shapes
    from nylon_amt_tpu_torch.train import step as st

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        write_corpus(cfg, feat, Path(tmp) / "corpus")
        ds = WindowDataset(SplitArrays.load(str(Path(tmp) / "corpus"),
                                            "train"), cfg,
                           n_slice=cfg.train.n_slice)
        first = next(ds.batches(cfg.train.batch_size))
    state = st.create_train_state(cfg, SEED, dev)
    apply, draw = st.make_apply(cfg)
    batch = st.to_device(first, dev)
    torch.cuda.synchronize()
    kernels.reset_launches()
    st.train_step(cfg, state, batch, draw(cfg, torch.Generator()
                                          .manual_seed(SEED)), apply)
    torch.cuda.synchronize()
    want = dict(f32_gemm_launches(cfg.model, train=True),
                ln_bwd=sum(c for _, c in ln_step_shapes(cfg.model)))
    counts = {k: kernels.launches[k] for k in want}
    if counts != want:
        raise AssertionError(f"(n) default f32 train step: GEMM and ln_bwd "
                             f"launches {counts}, expected {want}")
    del state, batch
    ms, _ = time_train_step(cfg, first, dev, card, phase="n",
                            what="default-config f32 ")
    return ms, counts


def check_float32(feat, audio, spec, dev, card, cli_main) -> dict:
    """(n): the default ``Config()`` in float32 (hid 64 over 2 heads:
    head_dim 32), and the f32 kernels at the paper widths (head_dim 64):
    (n.1) K10-K12 at D = 32 and 64; (n.2) K2-K5 at batch 32 and K7-K9
    forward and backward at batch 8, at the default and the paper widths;
    (n.3) K13 at D = 32 in bf16 and f32; (n.4) the engine's
    f32 forward at the default and the paper config, and the default
    config's int8 forward; (n.5) the CLI with no ``--config``; times of
    each. Returns the f32 times per wrapper, and the launch counts of
    (n.4)'s paper f32 forward, of the default f32 train step's dX and dW
    GEMMs, and of the paper f32 step's ("<name>/paper") from (n.2)'s paper
    layers."""
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
    train_names = ("encoder_layer_train", "encoder_layer_train/stem",
                   "encoder_layer_train/time", "decoder_layer_zero_train",
                   "decoder_layer_train")
    times.update(check_layers_f32(cfg, packed, spec, dev, names, "default"))
    times.update(check_train_layers_f32(model32, cfg, spec, dev, train_names,
                                        "default"))
    del packed
    gen = torch.Generator().manual_seed(SEED + 14)
    paper32 = reference_initialize(HFT(paper, dev), gen).eval()
    packed = engine.pack_params(paper32, torch.float32)
    times.update({f"{k}/paper": v for k, v in check_layers_f32(
        paper, packed, spec, dev, names, "paper").items()})
    paper_train = check_train_layers_f32(paper32, paper, spec, dev,
                                         train_names, "paper")
    times.update({f"{k}/paper": v for k, v in paper_train.items()})
    del packed
    # the paper step's dX / dW launches: (n.2)'s paper backward of each
    # layer times its layers in the model (the stem-fed K7, the other
    # frequency K7s, the time K7s, K8, K9 on each further decoder layer)
    enc, dec = paper32.encoder_spec2midi, paper32.decoder_spec2midi
    per_step = {"encoder_layer_train/stem": 1,
                "encoder_layer_train": len(enc.layers_freq) - 1,
                "encoder_layer_train/time": len(dec.layers_time),
                "decoder_layer_zero_train": 1,
                "decoder_layer_train": len(dec.layers_freq)}
    paper_bwd = {f"{k}/paper": sum(
        c * paper_train[f"{n}/bwd_gemm_launches"][k]
        for n, c in per_step.items()) for k in ("gemm_nt_f32", "wgrad_f32")}
    log(f"(n.2) the paper f32 step's dX / dW launches from its layers' "
        f"backwards {per_step}: {paper_bwd}")
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
    # and hid 96 over 3 heads of 32, pf 160 (V's quantizer's ragged column
    # block; Q and K of the QKV product inside one 192-column tile; the
    # stem kernel's ragged column block), bf16 and f32
    cfg96 = dataclasses.replace(cfg, model=dataclasses.replace(
        m, hid_dim=96, pf_dim=160, enc_head=3, dec_head=3))
    gen = torch.Generator().manual_seed(SEED + 21)
    m96 = reference_initialize(HFT(cfg96, dev), gen).eval()
    cfg96_16 = dataclasses.replace(cfg96, model=dataclasses.replace(
        cfg96.model, compute_dtype="bfloat16"))
    m96_16 = HFT(cfg96_16, dev)
    m96_16.load_state_dict(m96.state_dict())
    m96_16.eval()
    times.update(check_int8_d32(m96_16, m96, cfg96, spec, dev, "/hid96"))
    # (n.4) the hid-96 engine forward in f32 and int8 ((n.4)'s and (k)'s
    # gates) and bf16 ((m)'s): its stem, attention and layer kernels at a
    # hid that is not a multiple of 64. In bf16 on these weights the B
    # heads' end-to-end reading is printed, not held: offset_B reads 70.0
    # ulps from the plain bf16 forward, past (m)'s 64, while the stem kernel
    # is the plain stem bit for bit, the A heads read 2.0-3.0 of their 8,
    # the engine's stage 2 fed the plain stage-1 tokens stays within 64 and
    # (e)'s truth gate holds on every head: stage 2 on random weights
    # amplifies the stage-1 tokens' rounding (both forwards stand 0.5-0.9
    # from the f32 truth there; the default width reads 45-60 of its 64).
    # (m)'s gates in full are held on the same width at a second seed, and
    # the end-to-end gate at this width is an open question (ROADMAP)
    check_forward_f32(cfg96, m96, spec, dev, card, "hid 96", with_int8=True)
    check_engine_bf16(cfg96_16, m96_16, m96,
                      engine.pack_params(m96_16, torch.bfloat16), spec, dev,
                      card, "hid-96 bf16 forward (3 heads of 32, pf 160)",
                      phase="n.4", b_end_to_end=False)
    del m96, m96_16
    gen = torch.Generator().manual_seed(SEED + 22)
    m96 = reference_initialize(HFT(cfg96, dev), gen).eval()
    m96_16 = HFT(cfg96_16, dev)
    m96_16.load_state_dict(m96.state_dict())
    m96_16.eval()
    check_engine_bf16(cfg96_16, m96_16, m96,
                      engine.pack_params(m96_16, torch.bfloat16), spec, dev,
                      card, "hid-96 bf16 forward, second seed", phase="n.4")
    del m96, m96_16
    torch.cuda.empty_cache()

    # (n.4) the engine's f32 forwards
    fwd = check_forward_f32(cfg, model32, spec, dev, card, "default Config()",
                            with_int8=True)
    fwd_paper = check_forward_f32(paper, paper32, spec, dev, card,
                                  "paper_scale()", with_int8=False)
    del paper32
    torch.cuda.empty_cache()
    step_ms, step_counts = time_train_step_f32(cfg, feat, dev, card)
    log(f"(n) end to end, f32: default Config() batch-{BATCH} forward "
        f"{fwd['ms']:.3f} ms (int8 {fwd['int8_ms']:.3f} ms), paper_scale() "
        f"{fwd_paper['ms']:.3f} ms, default train step (batch "
        f"{cfg.train.batch_size}) {step_ms:.3f} ms; card {card}")

    # (n.5) the CLI with no --config
    default_cli_f32(feat, audio, cli_main)
    return times, {**fwd_paper["launches"], **paper_bwd,
                   **{k: step_counts[k] for k in ("gemm_nt_f32",
                                                  "wgrad_f32")},
                   "ln_bwd/default": step_counts["ln_bwd"]}


# (o) the bf16 layer GEMMs alone ---------------------------------------------

# csrc/layer_fused.cu's forward GEMMs, csrc/layer_fused_train.cu's dX and dW,
# csrc/layer_fused_f32.cu's float32 forward GEMMs, dX and dW (3xTF32 wgmma)
GEMM_KERNELS = ("gemm_bias_kernel", "gemm_res_ln_kernel", "gemm_nt_kernel",
                "wgrad_kernel", "gemm_bias_f32_kernel",
                "gemm_res_ln_f32_kernel", "gemm_nt_f32_kernel",
                "wgrad_f32_kernel")
# the TF32 GEMMs that hand registers between warpgroups (setmaxnreg): the
# consumers' 232 a thread balance the producer's 40 only from 168
SETMAXNREG_KERNELS = ("gemm_bias_f32_kernel", "gemm_res_ln_f32_kernel",
                      "gemm_nt_f32_kernel")
# the TMA-fed kernels of the f32-exact products and the instructions their
# SASS must hold: K1's DFT on the FP64 tensor cores (mma.sync .f64), the
# stem layer's QKV on FFMA
RING_KERNELS = {"log_mel_kernel": "DMMA", "gemm_bias_ffma_kernel": "FFMA"}
# the TMA-fed streaming kernels: the LayerNorm backward (bf16 with 1 or 3
# chunks a lane, f32 with 1-3, each with and without a dropout site) and
# V's quantizer (bf16 and f32)
STREAM_KERNELS = ("ln_bwd_kernel", "quant_cols_kernel")
STREAM_INSTANTIATIONS = (2 + 3) * 2 + 2
# (label, frequency-stream rows, note/time-stream rows, hid, pf, encoder,
# decoder and time layers, training forward): the paper batch-32 forward,
# the paper batch-8 training forward (dropout 0.1: the forward, then the
# forward recompute of the backward), the default widths' batch-32 forward,
# and a ragged geometry that check_geometry admits (hid 96 over 3 heads of
# 32, pf 160: K 96 and 160 are not multiples of 64, N 288 spans two tiles,
# and neither row count is a multiple of 128), inference and training
GEMM_GEOMETRIES = (
    ("paper b32", BATCH * 128 * 256, BATCH * 128 * 88, 256, 512, 3, 3, 3,
     False),
    ("paper b8 train", TRAIN_BATCH * 128 * 256, TRAIN_BATCH * 128 * 88, 256,
     512, 3, 3, 3, True),
    ("default b32", BATCH * 128 * 256, BATCH * 128 * 88, 64, 128, 2, 2, 2,
     False),
    ("ragged", 100_003, 35_201, 96, 160, 2, 2, 2, False),
    ("ragged train", 100_003, 35_201, 96, 160, 2, 2, 2, True),
)


def gemm_cases(mf, mq, hid, pf, n_enc, n_dec, n_time, train,
               f32: bool = False) -> list:
    """Every (label, kernel, M, K, N, relu, dropout site, pre_out, out,
    launches) that a forward (``train``: a training step's forward and
    its backward's recompute) of these widths runs: launches per forward
    or per step. In ``f32`` the stem layer's QKV is the CUDA cores' GEMM
    ("gemm_bias_ffma")."""
    mult = 2 if train else 1
    cases = [("qkv stem", "gemm_bias_ffma", mf, hid, 3 * hid, 0, False,
              False, True, mult)] if f32 else []
    for label, m, k, n, relu, count in (
            ("qkv freq", mf, hid, 3 * hid, 0, n_enc - int(f32)),
            ("ffn1 freq", mf, hid, pf, 1, n_enc),
            ("kv cross", mf, hid, 2 * hid, 0, n_dec),
            ("q cross", mq, hid, hid, 0, n_dec),
            ("qkv note/time", mq, hid, 3 * hid, 0, n_dec - 1 + n_time),
            ("ffn1 note/time", mq, hid, pf, 1, n_dec + n_time)):
        cases.append((label, "gemm_bias", m, k, n, relu, train and relu,
                      False, True, mult * count))
    for label, m, k, n, count, recompute in (
            ("o freq", mf, hid, hid, n_enc, (True, True)),
            ("ffn2 freq", mf, pf, hid, n_enc, (True, False)),
            ("o note/time", mq, hid, hid, 2 * n_dec - 1 + n_time,
             (True, True)),
            ("ffn2 note/time", mq, pf, hid, n_dec + n_time, (True, False))):
        cases.append((label, "gemm_res_ln", m, k, n, 0, train, False, True,
                      count))
        if train:  # the backward's recompute: pre_out [and out]
            cases.append((label, "gemm_res_ln", m, k, n, 0, True,
                          recompute[0], recompute[1], count))
    return cases


def gemm_ptxas(log_text: str, names=GEMM_KERNELS) -> dict:
    """Registers and spill bytes of every instantiation of the kernels
    ``names``, from the build's ``ptxas -v`` log."""
    out, fn = {}, None
    for ln in log_text.splitlines():
        if "Compiling entry function" in ln:
            fn = next((k for k in names if k in ln), None)
            name = ln.split("'")[1] if fn else None
        elif fn and "spill stores" in ln:
            spill = [int(w) for w in ln.replace(",", "").split()
                     if w.isdigit()]
            out[name] = dict(kernel=fn, stack=spill[0],
                             spill=spill[1] + spill[2])
        elif fn and "Used" in ln and name in out:
            out[name]["regs"] = int(ln.split("Used")[1].split()[0])
            fn = None
    return out


def start_sass(lib: Path):
    """Start ``cuobjdump -sass`` of the kernel library in the background
    (it takes ~20 s), into ``sass.txt`` beside it; returns the process, or
    None where the toolkit has no cuobjdump."""
    from nylon_amt_tpu_torch import kernels

    nvcc = kernels.find_nvcc()
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump") if nvcc else None
    if not tool or not os.path.exists(tool):
        return None
    with open(lib.parent / "sass.txt", "w") as out:
        proc = subprocess.Popen([tool, "-sass", str(lib)], stdout=out,
                                stderr=subprocess.STDOUT)
    atexit.register(proc.kill)  # a failed phase leaves nothing running
    return proc


def gemm_sass(proc, lib: Path, names=GEMM_KERNELS,
              ops=("HGMMA", "UTMALDG")) -> dict:
    """Counts of the instructions ``ops`` (HGMMA: wgmma; DMMA: mma.sync
    .f64; UTMALDG: TMA load) in each instantiation of the kernels
    ``names``, from the ``cuobjdump -sass`` run that ``start_sass``
    started."""
    if proc.wait(timeout=600):
        raise AssertionError(f"cuobjdump -sass {lib}: exit {proc.returncode}")
    counts, name = {}, None
    for ln in (lib.parent / "sass.txt").read_text().splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            name = name if any(k in name for k in names) else None
            if name:
                counts[name] = dict.fromkeys(ops, 0)
        elif name:
            for op in ops:
                counts[name][op] += op in ln
    return counts


def check_gemms(dev, card: str) -> None:
    """(o): gemm_bias_kernel and gemm_res_ln_kernel alone, at every (M, K,
    N) and variant of GEMM_GEOMETRIES, against their plain twins
    (``layer_fused.gemm_bias_plain`` / ``gemm_res_ln_plain``): within ULPS
    bf16 ulps of the plain bf16 twin and under the bf16 gate against the
    f32 truth (the twin on the inputs in f32, the same masks), pre_out
    likewise, two runs bit-identical; the kernel's time beside its bound,
    and bf16 ``torch.matmul`` of the same product (+ ``F.layer_norm`` of
    the residual sum for gemm_res_ln), which the port never calls."""
    import torch.nn.functional as F

    from nylon_amt_tpu_torch.ops import layer_fused as lf
    from nylon_amt_tpu_torch.ops import layer_fused_train as lft
    from nylon_amt_tpu_torch.ops.precision import full_f32

    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 15)
    bf = torch.bfloat16
    totals = {}
    for geo, mf, mq, hid, pf, n_enc, n_dec, n_time, train in GEMM_GEOMETRIES:
        for case in gemm_cases(mf, mq, hid, pf, n_enc, n_dec, n_time, train):
            label, kern, m, k, n, relu, drop, pre, out, count = case

            def r(*shape):
                return torch.randn(shape, generator=g, device=dev)

            a, w = r(m, k).to(bf), (r(k, n) / math.sqrt(k)).to(bf)
            res = r(m, n).to(bf) if kern == "gemm_res_ln" else None
            bias, gam, bet = (0.1 * r(n)).to(bf), 1.0 + 0.1 * r(n), 0.1 * r(n)
            tag = (lft._SITE_FFN_MID if kern == "gemm_bias"
                   else lft._SITE_ATTN_OUT)
            site = lft._site(DROP_SEED, tag, n, RATE, bf) if drop \
                else None
            if kern == "gemm_bias":
                def run():
                    return {"out": lft._gemm_bias(a, w, bias, relu, site)}
                plain = {"out": lf.gemm_bias_plain(a, w, bias, relu, site)}
                with full_f32():
                    truth = {"out": lf.gemm_bias_plain(
                        a.float(), w.float(), bias.float(), relu, site)}
            else:
                def run():
                    y, p = lft._gemm_res_ln(a, w, bias, res, gam, bet, site,
                                            pre=pre, out=out)
                    return {k_: v for k_, v in (("out", y), ("pre", p))
                            if v is not None}
                y, p = lf.gemm_res_ln_plain(a, w, bias, res, gam, bet, site)
                plain = {"out": y, "pre": p}
                with full_f32():
                    y, p = lf.gemm_res_ln_plain(a.float(), w.float(),
                                                bias.float(), res.float(),
                                                gam, bet, site)
                truth = {"out": y, "pre": p}
            got, again = run(), run()
            torch.cuda.synchronize()
            gates = []
            for key, v in got.items():
                err, ulps = ulp_distance(v, plain[key])
                e_k, e_p = bf16_gate(f"{kern} {geo} {label} {key}", v,
                                     plain[key], truth[key])
                if not ulps <= ULPS:
                    raise AssertionError(
                        f"{kern} {geo} {label} [{m},{k},{n}] {key}: "
                        f"{ulps:.2f} ulps from the plain bf16 twin > {ULPS}")
                if not torch.equal(v.view(torch.int16),
                                   again[key].view(torch.int16)):
                    raise AssertionError(f"{kern} {geo} {label} {key}: two "
                                         f"runs differ")
                gates.append(f"{key} {ulps:.2f} ulps, gate {e_k:.5f} vs "
                             f"{e_p:.5f}")
            del plain, truth
            ms = cuda_ms(run, iters=5)
            mm = cuda_ms(lambda: a @ w, iters=5)
            nbytes_ = 2 * (m * k + k * n + m * n * len(got)) + 2 * n
            lib = f"matmul {mm:.3f} ms"
            if kern == "gemm_res_ln":
                nbytes_ += 2 * m * n + 8 * n
                g16, b16 = gam.to(bf), bet.to(bf)
                mmln = cuda_ms(lambda: F.layer_norm(a @ w + bias + res, (n,),
                                                    g16, b16, 1e-5), iters=5)
                lib += f", matmul + layer_norm {mmln:.3f} ms"
            bd = bound(nbytes_, 2 * m * k * n)
            variant = ("relu " if relu else "") + ("drop " if drop else "") \
                + ("pre " if pre else "") + ("" if out else "no-out ")
            log(f"(o) {kern} {geo} {label} [{m},{k},{n}] {variant}"
                f"x{count}: {'; '.join(gates)}; bit-identical reruns; "
                f"kernel {ms:.3f} ms, bound {bd['bound_ms']:.3f} ms "
                f"({bd['bound_by']}), {nbytes_ / ms / 1e9:.2f} TB/s, "
                f"{bd['bound_ms'] / ms:.1%} of the bound; {lib}")
            tot = totals.setdefault(geo, [0.0, 0.0, 0.0])
            tot[0] += count * ms
            tot[1] += count * bd["bound_ms"]
            tot[2] += count * mm
            del a, w, res, got, again
    for geo, (ms, bd, mm) in totals.items():
        log(f"(o) {geo}: GEMMs of one {'step' if 'train' in geo else 'forward'}"
            f" {ms:.3f} ms, bound {bd:.3f} ms ({bd / ms:.1%}), bf16 "
            f"torch.matmul of the same products {mm:.3f} ms")
    log(f"(o) done in {time.perf_counter() - t_phase:.1f} s; card {card}")


# (p) the bf16 backward GEMMs alone -----------------------------------------

# (label, frequency-stream rows, note/time-stream rows, hid, pf, encoder,
# decoder and time layers) of a batch-8 training step's backward at dropout
# RATE: the paper widths, the default widths and (o)'s ragged geometry;
# tools/gemm_ab.py's step_bwd_products lists each one's dX and dW products
BWD_GEOMETRIES = (
    ("paper b8", TRAIN_BATCH * 128 * 256, TRAIN_BATCH * 128 * 88, 256, 512,
     3, 3, 3),
    ("default b8", TRAIN_BATCH * 128 * 256, TRAIN_BATCH * 128 * 88, 64, 128,
     2, 2, 2),
    ("ragged", 100_003, 35_201, 96, 160, 2, 2, 2),
)


def check_bwd_gemms(dev, card: str) -> None:
    """(p): gemm_nt_kernel and wgrad_kernel (csrc/layer_fused_train.cu)
    alone, at every product of BWD_GEOMETRIES, against their plain twins
    (``layer_fused_train.gemm_nt_plain`` / ``weight_grad_plain``): dX within
    ULPS bf16 ulps of the plain bf16 twin and under the bf16 gate against
    the f32 truth (the twin on the inputs in f32, the same masks); dW and
    the bias sums no further from a float64 truth of the same bf16 operands
    than twice the plain f32 twin's own distance + 1e-6 max |truth| (f32
    sums in another order); two runs bit-identical. Each kernel's time
    beside its bound and bf16 ``torch.matmul`` of the same product (``dy @
    w.t()``; ``a.t() @ dy`` and ``dy.sum(0)``), which the port never
    calls."""
    from nylon_amt_tpu_torch.ops import layer_fused_train as lft
    from nylon_amt_tpu_torch.ops.precision import full_f32
    from nylon_amt_tpu_torch.tools.gemm_ab import step_bwd_products

    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    bf = torch.bfloat16

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev)

    totals = {}
    for geo, mf, mq, hid, pf, n_enc, n_dec, n_time in BWD_GEOMETRIES:
        for case in step_bwd_products(mf, mq, hid, pf, n_enc, n_dec,
                                      n_time):
            label, kern, m, k, n = case[:5]
            count = case[-1]
            if kern == "gemm_nt":
                side, act1, act2 = case[5:8]
                dy, w = r(m, k).to(bf), (r(n, k) / math.sqrt(k)).to(bf)
                sides = {side: r(m, n).to(bf)} if side else {}
                m1 = lft._site(DROP_SEED, lft._SITE_FFN_MID, n, RATE, bf) \
                    if act1 else None
                m2 = lft._site(DROP_SEED, lft._SITE_EMB, n, RATE, bf) \
                    if act2 else None

                def run():
                    return lft._gemm_nt(dy, w, m1=m1, m2=m2, **sides)
                plain = lft.gemm_nt_plain(dy, w, m1=m1, m2=m2, **sides)
                with full_f32():
                    truth = lft.gemm_nt_plain(
                        dy.float(), w.float(), m1=m1, m2=m2,
                        **{k_: v.float() for k_, v in sides.items()})
                got, again = run(), run()
                torch.cuda.synchronize()
                err, ulps = ulp_distance(got, plain)
                e_k, e_p = bf16_gate(f"gemm_nt {geo} {label}", got, plain,
                                     truth)
                if not ulps <= ULPS:
                    raise AssertionError(
                        f"gemm_nt {geo} {label} [{m},{k},{n}]: {ulps:.2f} "
                        f"ulps from the plain bf16 twin > {ULPS}")
                same = torch.equal(got.view(torch.int16),
                                   again.view(torch.int16))
                gate = f"{ulps:.2f} ulps, gate {e_k:.5f} vs {e_p:.5f}"
                del plain, truth, got, again
                nbytes_ = 2 * (m * k + n * k + m * n * (1 + len(sides)))
                flops = 2 * m * k * n
                ms = cuda_ms(run, iters=5)
                mm = cuda_ms(lambda: dy @ w.t(), iters=5)
                variant = " ".join(([side] if side else [])
                                   + (["m1"] if act1 else [])
                                   + (["m2"] if act2 else []))
                shape = f"[{m},{k}->{n}] {variant}"
                del dy, w, sides
            else:
                a, dy = r(m, k).to(bf), r(m, n).to(bf)

                def run():
                    return lft._weight_grad(a, dy)
                got, again = run(), run()
                plain = lft.weight_grad_plain(a, dy)
                truth = (a.double().t() @ dy.double(), dy.double().sum(0))
                torch.cuda.synchronize()
                gates = []
                for name, v, p_, t in zip(("dW", "bias"), got, plain, truth):
                    d_k = (v.double() - t).abs().max().item()
                    d_p = (p_.double() - t).abs().max().item()
                    lim = 2 * d_p + 1e-6 * t.abs().max().item()
                    if not d_k <= lim:
                        raise AssertionError(
                            f"wgrad {geo} {label} [{m},{k},{n}] {name}: "
                            f"{d_k:.3e} from the float64 truth > {lim:.3e} "
                            f"(plain f32 {d_p:.3e})")
                    gates.append(f"{name} {d_k:.3e} (plain f32 {d_p:.3e})")
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                gate = "from float64: " + ", ".join(gates)
                del got, again, plain, truth
                nbytes_ = 2 * (m * k + m * n) + 4 * (k * n + n)
                flops = 2 * m * k * n
                ms = cuda_ms(run, iters=5)
                mm = cuda_ms(lambda: (a.t() @ dy, dy.sum(0)), iters=5)
                shape = f"[{m},{k}x{n}]"
                del a, dy
            if not same:
                raise AssertionError(f"{kern} {geo} {label}: two runs differ")
            bd = bound(nbytes_, flops)
            log(f"(p) {kern} {geo} {label} {shape} x{count}: {gate}; "
                f"bit-identical reruns; kernel {ms:.3f} ms, bound "
                f"{bd['bound_ms']:.3f} ms ({bd['bound_by']}), "
                f"{nbytes_ / ms / 1e9:.2f} TB/s, "
                f"{bd['bound_ms'] / ms:.1%} of the bound; matmul {mm:.3f} ms")
            tot = totals.setdefault((geo, kern), [0, 0.0, 0.0, 0.0])
            tot[0] += count
            tot[1] += count * ms
            tot[2] += count * bd["bound_ms"]
            tot[3] += count * mm
            torch.cuda.empty_cache()
    for (geo, kern), (c, ms, bd, mm) in totals.items():
        log(f"(p) {geo}: the step's {c} {kern} launches {ms:.3f} ms, bound "
            f"{bd:.3f} ms ({bd / ms:.1%}), bf16 torch.matmul of the same "
            f"products {mm:.3f} ms")
    log(f"(p) done in {time.perf_counter() - t_phase:.1f} s; card {card}")


# (q) the float32 layer GEMMs alone ------------------------------------------

def check_gemms_f32(dev, card: str) -> dict:
    """(q): gemm_bias_f32_kernel and gemm_res_ln_f32_kernel (3xTF32 wgmma,
    csrc/layer_fused_f32.cu), and the stem layer's QKV GEMM on the CUDA
    cores (gemm_bias_ffma_kernel), alone at every (M, K, N) and variant
    of GEMM_GEOMETRIES in float32: the paper batch-32 forward, the paper
    batch-8 training forward (dropout sites, ``pre_out``, ``out`` None), the
    default ``Config()`` widths' batch-32 forward, hid 96 / pf 160 with
    ragged M. Each within F32_OUT_REL of max(1, max |plain f32 twin|)
    (``gemm_bias_plain`` / ``gemm_res_ln_plain``), ``pre_out`` likewise,
    two runs bit-identical; the kernel's and the twin's distances from a
    float64 truth of the same operands, the QKV's gated within twice the
    twin's + 4 f32 ulps; the kernel's time beside its bound
    (bytes, or the products as 3xTF32 at 494.7 / 3 TFLOP/s), the FFMA bound
    (the products at 67 TFLOP/s) and f32 ``torch.matmul`` (IEEE f32) of
    the same product, which the port never calls. The weight's TF32 pair
    is packed once a shape, as the engine packs it. Returns the rows of the
    three kernels for the JSON line: the paper batch-32 forward's shapes
    summed over its launches, with those launches under "launches"."""
    from nylon_amt_tpu_torch.ops import layer_fused as lf
    from nylon_amt_tpu_torch.ops import layer_fused_train as lft
    from nylon_amt_tpu_torch.ops.precision import full_f32
    from nylon_amt_tpu_torch.tools.gemm_ab import f64_twin

    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    f32 = torch.float32
    totals, rows = {}, {}
    for geo, mf, mq, hid, pf, n_enc, n_dec, n_time, train in GEMM_GEOMETRIES:
        for case in gemm_cases(mf, mq, hid, pf, n_enc, n_dec, n_time, train,
                               f32=True):
            label, kern, m, k, n, relu, drop, pre, out, count = case

            def r(*shape):
                return torch.randn(shape, generator=g, device=dev)

            x = dict(a=r(m, k), w=r(k, n) / math.sqrt(k), b=0.1 * r(n),
                     res=r(m, n) if kern == "gemm_res_ln" else None,
                     g=1.0 + 0.1 * r(n), be=0.1 * r(n))
            ffma = kern == "gemm_bias_ffma"   # reads w itself
            pair = None if ffma else lf.tf32_pair(x["w"])
            tag = (lft._SITE_FFN_MID if kern == "gemm_bias"
                   else lft._SITE_ATTN_OUT)
            site = lft._site(DROP_SEED, tag, n, RATE, f32) if drop else None
            if ffma:
                def run():
                    return {"out": lf._gemm_ffma(x["a"], x["w"], x["b"])}

                def plain_run():
                    return {"out": lf.gemm_bias_plain(x["a"], x["w"], x["b"],
                                                      relu, site)}
            elif kern == "gemm_bias":
                def run():
                    return {"out": lft._gemm_bias(x["a"], x["w"], x["b"],
                                                  relu, site, pair=pair)}

                def plain_run():
                    return {"out": lf.gemm_bias_plain(x["a"], x["w"], x["b"],
                                                      relu, site)}
            else:
                def run():
                    y, p = lft._gemm_res_ln(x["a"], x["w"], x["b"], x["res"],
                                            x["g"], x["be"], site, pre=pre,
                                            out=out, pair=pair)
                    return {k_: v for k_, v in (("out", y), ("pre", p))
                            if v is not None}

                def plain_run():
                    y, p = lf.gemm_res_ln_plain(x["a"], x["w"], x["b"],
                                                x["res"], x["g"], x["be"],
                                                site)
                    return {"out": y, "pre": p}
            got, again = run(), run()
            torch.cuda.synchronize()
            with full_f32():
                plain = plain_run()
            kind = ("ln" if kern == "gemm_res_ln" else "bias", m, k, n, relu,
                    drop, 1, 1)
            truth = dict(zip(("out", "pre") if kind[0] == "ln" else ("out",),
                             f64_twin(kind, {k_: v for k_, v in x.items()
                                             if v is not None}, site)))
            gates = []
            worst = 0.0
            for key, v in got.items():
                e = rel_err(v, plain[key], 1.0)
                e64 = f64_dist(v, truth[key])
                p64 = f64_dist(plain[key], truth[key])
                if not e <= F32_OUT_REL:
                    raise AssertionError(
                        f"(q) {kern} {geo} {label} [{m},{k},{n}] {key}: "
                        f"{e:.2e} of max(1, |plain f32|) > {F32_OUT_REL}; "
                        f"from float64 kernel {e64:.2e}, plain {p64:.2e}")
                if not torch.equal(v.view(torch.int32),
                                   again[key].view(torch.int32)):
                    raise AssertionError(f"(q) {kern} {geo} {label} {key}: "
                                         f"two runs differ")
                # the QKV's fmaf chain is not the twin's summation order:
                # from float64 within twice the twin's distance + 4 f32 ulps
                if ffma and not e64 <= 2 * p64 + 4 * F32_EPS:
                    raise AssertionError(
                        f"(q) {kern} {geo} {label} [{m},{k},{n}] {key}: "
                        f"{e64:.2e} from float64 > twice the plain f32 "
                        f"twin's {p64:.2e} + {4 * F32_EPS:.1e}")
                worst = max(worst, e)
                gates.append(f"{key} {e:.2e} of max(1, |plain f32|), from "
                             f"float64 kernel {e64:.2e}, plain {p64:.2e}")
            del plain, truth, again
            ms = cuda_ms(run, iters=5)
            with full_f32():
                plain_ms = cuda_ms(plain_run, iters=3)
                mm = cuda_ms(lambda: x["a"] @ x["w"], iters=5)
            nbytes_ = 4 * (m * k + (1 if ffma else 2) * k * n
                           + m * n * len(got) + n) + (
                4 * m * n + 8 * n if kern == "gemm_res_ln" else 0)
            flops = 2 * m * k * n
            bd = bound(nbytes_, **{"f32_flops" if ffma else "tf32x3_flops":
                                   flops})
            ffma_bd = bound(nbytes_, f32_flops=flops)["bound_ms"]
            variant = ("relu " if relu else "") + ("drop " if drop else "") \
                + ("pre " if pre else "") + ("" if out else "no-out ")
            log(f"(q) {kern}_f32 {geo} {label} [{m},{k},{n}] {variant}"
                f"x{count}: {'; '.join(gates)}; bit-identical reruns; "
                f"kernel {ms:.3f} ms, bound {bd['bound_ms']:.3f} ms "
                f"({bd['bound_by']}, {bd['bound_ms'] / ms:.1%}), FFMA bound "
                f"{ffma_bd:.3f} ms, f32 matmul {mm:.3f} ms ({ms / mm:.2f}x), "
                f"plain f32 twin {plain_ms:.3f} ms")
            tot = totals.setdefault(geo, [0.0] * 4)
            for i, v in enumerate((ms, bd["bound_ms"], ffma_bd, mm)):
                tot[i] += count * v
            if geo == "paper b32":
                row = rows.setdefault(f"{kern}_f32", dict(
                    max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                    nbytes=0, flops=0, launches=0))
                row["max_abs_err"] = max(row["max_abs_err"], worst)
                for key_, v in (("ms", ms), ("plain_ms", plain_ms),
                                ("library_ms", mm), ("nbytes", nbytes_),
                                ("flops", flops), ("launches", 1)):
                    row[key_] += count * v
            del x, got, pair
            torch.cuda.empty_cache()
    for geo, (ms, bd, ffma, mm) in totals.items():
        log(f"(q) {geo}: f32 GEMMs of one "
            f"{'step' if 'train' in geo else 'forward'} {ms:.3f} ms, bound "
            f"{bd:.3f} ms ({bd / ms:.1%}), FFMA bound {ffma:.3f} ms, f32 "
            f"torch.matmul of the same products {mm:.3f} ms")
    log(f"(q) done in {time.perf_counter() - t_phase:.1f} s; card {card}")
    for name, row in rows.items():
        row.update(bound(row.pop("nbytes"), **{
            "f32_flops" if "ffma" in name else "tf32x3_flops":
            row.pop("flops")}))
        row["gate"] = (f"<= {F32_OUT_REL} of max(1, |plain f32|) at every "
                       f"shape of (q); the paper batch-32 forward's shapes "
                       f"summed over its launches")
    return rows


# (r) the float32 backward GEMMs alone ---------------------------------------

def check_bwd_gemms_f32(dev, card: str) -> dict:
    """(r): gemm_nt_f32_kernel and wgrad_f32_kernel (3xTF32 on wgmma,
    csrc/layer_fused_f32.cu) alone at every product of BWD_GEOMETRIES in
    float32, against their plain twins (``layer_fused_train.gemm_nt_plain``
    / ``weight_grad_plain`` under ``full_f32``): dX within F32_OUT_REL of
    max(1, max |plain f32 twin|); dW and the bias sums no further from a
    float64 truth of the same operands than twice the plain f32 twin's own
    distance + 1e-6 max |truth|; two runs bit-identical. dX reads the
    weight's dX pair, packed once a shape as the training step packs it.
    Per shape the kernel's time beside its bound (bytes, or the products as
    3xTF32 at 494.7 / 3 TFLOP/s), f32 ``torch.matmul`` of the same product
    (``dy @ w.t()``; ``a.t() @ dy`` and ``dy.sum(0)``), which the port never
    calls, and the plain twin.
    The kernel and the matmul are timed by ``gemm_ab.graph_ms`` (a CUDA
    graph of 20 calls: at the default widths a call's host work outlasts
    its kernels), the plain twin by CUDA events around back-to-back calls.
    Returns the two kernels' rows for the JSON line by (geometry, name):
    the default and the paper batch-8 step's products summed over their
    launches, the launches themselves under "launches"."""
    from nylon_amt_tpu_torch.ops import layer_fused as lf
    from nylon_amt_tpu_torch.ops import layer_fused_train as lft
    from nylon_amt_tpu_torch.ops.precision import full_f32
    from nylon_amt_tpu_torch.tools.gemm_ab import graph_ms, step_bwd_products

    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 18)
    f32 = torch.float32

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev)

    totals, rows = {}, {}
    for geo, mf, mq, hid, pf, n_enc, n_dec, n_time in BWD_GEOMETRIES:
        for case in step_bwd_products(mf, mq, hid, pf, n_enc, n_dec,
                                      n_time):
            label, kern, m, k, n = case[:5]
            count = case[-1]
            if kern == "gemm_nt":
                side, act1, act2 = case[5:8]
                dy, w = r(m, k), r(n, k) / math.sqrt(k)
                pair = lf.tf32_pair(w, nt=True)
                sides = {side: r(m, n)} if side else {}
                m1 = lft._site(DROP_SEED, lft._SITE_FFN_MID, n, RATE, f32) \
                    if act1 else None
                m2 = lft._site(DROP_SEED, lft._SITE_EMB, n, RATE, f32) \
                    if act2 else None

                def run():
                    return lft._gemm_nt(dy, w, m1=m1, m2=m2, pair=pair,
                                        **sides)

                def plain_run():
                    return lft.gemm_nt_plain(dy, w, m1=m1, m2=m2, **sides)
                got, again = run(), run()
                torch.cuda.synchronize()
                with full_f32():
                    plain = plain_run()
                    truth = lft.gemm_nt_plain(
                        dy.double(), w.double(), m1=m1, m2=m2,
                        **{k_: v.double() for k_, v in sides.items()})
                err = rel_err(got, plain, 1.0)
                e64, p64 = f64_dist(got, truth), f64_dist(plain, truth)
                if not err <= F32_OUT_REL:
                    raise AssertionError(
                        f"(r) gemm_nt_f32 {geo} {label} [{m},{k}->{n}]: "
                        f"{err:.2e} of max(1, |plain f32|) > {F32_OUT_REL}; "
                        f"from float64 kernel {e64:.2e}, plain {p64:.2e}")
                same = torch.equal(got.view(torch.int32),
                                   again.view(torch.int32))
                gate = (f"{err:.2e} of max(1, |plain f32|), from float64 "
                        f"kernel {e64:.2e}, plain {p64:.2e}")
                del plain, truth, got, again
                nbytes_ = 4 * (m * k + n * k + m * n * (1 + len(sides)))
                ms = graph_ms(run)
                with full_f32():
                    plain_ms = cuda_ms(plain_run, iters=3)
                    mm = graph_ms(lambda: dy @ w.t())
                variant = " ".join(([side] if side else [])
                                   + (["m1"] if act1 else [])
                                   + (["m2"] if act2 else []))
                shape = f"[{m},{k}->{n}] {variant}"
                del dy, w, sides, pair
            else:
                a, dy = r(m, k), r(m, n)

                def run():
                    return lft._weight_grad(a, dy)

                def plain_run():
                    return lft.weight_grad_plain(a, dy)
                got, again = run(), run()
                with full_f32():
                    plain = plain_run()
                truth = (a.double().t() @ dy.double(), dy.double().sum(0))
                torch.cuda.synchronize()
                gates, err = [], 0.0
                for name, v, p_, t in zip(("dW", "bias"), got, plain, truth):
                    d_k = (v.double() - t).abs().max().item()
                    d_p = (p_.double() - t).abs().max().item()
                    lim = 2 * d_p + 1e-6 * t.abs().max().item()
                    if not d_k <= lim:
                        raise AssertionError(
                            f"(r) wgrad_f32 {geo} {label} [{m},{k}x{n}] "
                            f"{name}: {d_k:.3e} from the float64 truth > "
                            f"{lim:.3e} (plain f32 {d_p:.3e})")
                    err = max(err, rel_err(v, p_))
                    gates.append(f"{name} {d_k:.3e} (plain f32 {d_p:.3e}, "
                                 f"limit {lim:.3e})")
                same = all(torch.equal(x, y) for x, y in zip(got, again))
                gate = "from float64: " + ", ".join(gates)
                del got, again, plain, truth
                nbytes_ = 4 * (m * k + m * n + k * n + n)
                ms = graph_ms(run)
                with full_f32():
                    plain_ms = cuda_ms(plain_run, iters=3)
                    mm = graph_ms(lambda: (a.t() @ dy, dy.sum(0)))
                shape = f"[{m},{k}x{n}]"
                del a, dy
            if not same:
                raise AssertionError(f"(r) {kern}_f32 {geo} {label}: two "
                                     f"runs differ")
            flops = 2 * m * k * n
            bd = bound(nbytes_, tf32x3_flops=flops)
            log(f"(r) {kern}_f32 {geo} {label} {shape} x{count}: {gate}; "
                f"bit-identical reruns; kernel {ms:.3f} ms, bound "
                f"{bd['bound_ms']:.3f} ms ({bd['bound_by']}, "
                f"{bd['bound_ms'] / ms:.1%}), f32 matmul {mm:.3f} ms "
                f"({ms / mm:.2f}x), plain f32 twin {plain_ms:.3f} ms")
            tot = totals.setdefault((geo, kern), [0, 0.0, 0.0, 0.0])
            for i, v in enumerate((1, ms, bd["bound_ms"], mm)):
                tot[i] += count * v
            if geo in ("default b8", "paper b8"):
                row = rows.setdefault((geo, kern), dict(
                    max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                    nbytes=0, flops=0, launches=0))
                row["max_abs_err"] = max(row["max_abs_err"], err)
                for key_, v in (("ms", ms), ("plain_ms", plain_ms),
                                ("library_ms", mm), ("nbytes", nbytes_),
                                ("flops", flops), ("launches", 1)):
                    row[key_] += count * v
            torch.cuda.empty_cache()
    for (geo, kern), (c, ms, bd, mm) in totals.items():
        log(f"(r) {geo}: the step's {c} {kern}_f32 launches {ms:.3f} ms, "
            f"bound {bd:.3f} ms ({bd / ms:.1%}), f32 torch.matmul of the "
            f"same products {mm:.3f} ms")
    log(f"(r) done in {time.perf_counter() - t_phase:.1f} s; card {card}")
    out = {}
    for (geo, kern), row in rows.items():
        row.update(bound(row.pop("nbytes"), tf32x3_flops=row.pop("flops")))
        row["gate"] = (
            f"every product of (r): dX <= {F32_OUT_REL} of max(1, |plain "
            f"f32|); dW and bias sums within 2 x the plain f32 twin's "
            f"float64 distance + 1e-6 max |truth|; max_abs_err of max "
            f"|plain f32|; the {geo} step's products summed over its "
            f"launches")
        out[(geo, f"{kern}_f32")] = row
    return out


# (s) the int8 layer GEMMs alone ---------------------------------------------

# csrc/layer_fused_q8.cu's s8 GEMMs (wgmma .s32.s8.s8 fed by TMA): their
# SASS must hold IGMMA (int8 wgmma) and UTMALDG (TMA load)
Q8_GEMM_KERNELS = ("gemm_q8_bias_kernel", "gemm_q8_res_ln_kernel")
# and the int8 attention (its products on wgmma too: IGMMA and UTMALDG, and
# no mma.sync, IMMA, left in its SASS); gemm_q8_bias_kernel hands its
# producer warpgroup's registers to its consumers (setmaxnreg), which holds
# only if ptxas gives it 168
Q8_WGMMA_KERNELS = Q8_GEMM_KERNELS + ("attention_q8_kernel",)
# The mma.sync s8 GEMMs that these replaced, summed over the 43 launches of
# the paper batch-32 int8 forward, and the bf16 wgmma GEMMs of the same 43
# products (ms; (k)'s and (o)'s profiles of the parent tree, NVIDIA H100
# 80GB HBM3, 700 W; PERF.md section 6)
Q8_GEMM_BEFORE_MS, BF16_GEMM_MS = 51.771, 17.494
# (label, frequency-stream rows, note/time-stream rows, hid, pf, encoder,
# decoder and time layers): the paper batch-32 int8 forward, the default
# widths' and a ragged geometry (hid 96, pf 160: K 96 and 160 not multiples
# of the 128-deep stage, N 288 over two tiles, N 96 under one, neither row
# count a multiple of 128)
Q8_GEMM_GEOMETRIES = (
    ("paper b32", BATCH * 128 * 256, BATCH * 128 * 88, 256, 512, 3, 3, 3),
    ("default b32", BATCH * 128 * 256, BATCH * 128 * 88, 64, 128, 2, 2, 2),
    ("ragged", 100_003, 35_201, 96, 160, 2, 2, 2),
)


def check_gemms_q8(dev, card: str, geometries=Q8_GEMM_GEOMETRIES) -> dict:
    """(s): gemm_q8_bias_kernel and gemm_q8_res_ln_kernel alone, at every
    product of ``geometries`` in the variant the int8 forward runs it
    (``gemm_ab.q8_products``: ReLU, the GEMM + bias's row codes of its
    column segments, quant_out) in bf16 and f32, on the codes and scales
    of seeded activations and weights (the plain quantizers'), the weights
    handed K-major as ``pack_wt`` packs them: gemm_q8_bias bit for bit
    equal to ``gemm_q8_bias_plain``, its codes and scales (Q and K of the
    QKV product, K of the cross KV product, the cross Q, the FFN hidden
    after ReLU) those of ``_quant_rows`` of each segment of its output
    (``gemm_q8_bias_codes_plain``), bit for bit; gemm_q8_res_ln within ULPS
    bf16 ulps of ``gemm_q8_res_ln_plain`` (bf16) or F32_OUT_REL of max(1,
    |plain|) (f32), its output codes and scales those of ``_quant_rows`` of
    its own output, bit for bit; two runs bit-identical. Per product the
    kernel's time (a CUDA graph of 20 calls, ``gemm_ab.graph_ms``), its
    bound (bytes, or the int8 products at 1,979 TOP/s), the exact kernel of
    the same product in the same dtype (bf16 wgmma, or f32 3xTF32 wgmma
    with its TF32 pair), ``torch._int_mm`` (s8 x s8 -> s32), which the
    port never calls, and (paper bf16) the plain twin. Returns the paper
    batch-32 bf16 forward's sums."""
    from nylon_amt_tpu_torch.ops import layer_fused as lf
    from nylon_amt_tpu_torch.ops import layer_fused_q8 as lq
    from nylon_amt_tpu_torch.tools.gemm_ab import graph_ms, q8_products

    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 19)

    def r(*shape):
        return torch.randn(shape, generator=g, device=dev)

    totals, summary = {}, {}
    biggest = {}  # the product with the largest bound: what bounds the sum
    for geo, mf, mq, hid, pf, n_enc, n_dec, n_time in geometries:
        for dt in (torch.bfloat16, torch.float32):
            label_dt = "bf16" if dt == torch.bfloat16 else "f32"
            timed_plain = geo == "paper b32" and label_dt == "bf16"
            for case in q8_products(mf, mq, hid, pf, n_enc, n_dec, n_time):
                label, kern, m, k, n, relu, var, count = case
                ln = kern == "gemm_q8_res_ln"
                x = r(m, k).to(dt)
                w = (r(k, n) / math.sqrt(k)).to(dt)
                aq, sa = lq._quant_rows(x)
                sa = sa.reshape(-1).contiguous()
                wq, sw = lq.quantize_weight(w)
                wt = wq.t().contiguous()
                bias = (0.1 * r(n)).to(dt)
                res = r(m, n).to(dt) if ln else None
                gam, bet = 1.0 + 0.1 * r(n), 0.1 * r(n)
                if ln:
                    def run():
                        return lq._gemm_q8_res_ln(aq, sa, wq, sw, bias, res,
                                                  gam, bet, bool(var), wt=wt)

                    def plain():
                        return lq.gemm_q8_res_ln_plain(
                            aq, sa, wq, sw, bias, res, gam, bet, bool(var))
                elif var:
                    def run():
                        return lq._gemm_q8(aq, sa, wq, sw, bias, relu, wt=wt,
                                           seg=var[0], n_seg=var[1],
                                           t_out=bool(var[2]))

                    def plain():
                        return lq.gemm_q8_bias_codes_plain(
                            aq, sa, wq, sw, bias, relu, var[0], var[1])
                else:
                    def run():
                        return (lq._gemm_q8(aq, sa, wq, sw, bias, relu,
                                            wt=wt),)

                    def plain():
                        return (lq.gemm_q8_bias_plain(aq, sa, wq, sw, bias,
                                                      relu),)
                want = plain()
                got, again = run(), run()
                torch.cuda.synchronize()
                bits = torch.int16 if dt == torch.bfloat16 else torch.int32
                what = f"{kern} {label_dt} {geo} {label} [{m},{k},{n}]"
                nc = var[0] * var[1] if var and not ln else 0

                def written(t, first):  # a codes run writes no T code columns
                    t = t[:, nc:] if first else t
                    return t.view(bits) if t.is_floating_point() else t
                if not all(torch.equal(written(a_, i == 0),
                                       written(b_, i == 0))
                           for i, (a_, b_) in enumerate(zip(got, again))
                           if a_ is not None):
                    raise AssertionError(f"(s) {what}: two runs differ")
                out = got[0]
                if out is not None and not torch.isfinite(
                        out[:, nc:].float()).all():
                    raise AssertionError(f"(s) {what}: non-finite output")
                if not ln:
                    if out is not None and not torch.equal(
                            out[:, nc:].view(bits), want[0][:, nc:].view(bits)):
                        d = (out[:, nc:].float()
                             - want[0][:, nc:].float()).abs()
                        raise AssertionError(
                            f"(s) {what}: not bit-identical to "
                            f"gemm_q8_bias_plain ({int((d > 0).sum())} "
                            f"elements differ, max {d.max().item():.3e})")
                    err, gate = 0.0, "bit-identical to the plain twin"
                    if var:
                        if not (torch.equal(got[1], want[1])
                                and torch.equal(got[2], want[2])):
                            raise AssertionError(
                                f"(s) {what}: the codes or scales of its "
                                f"{var[1]} segment(s) of {var[0]} columns "
                                f"differ from _quant_rows of the plain "
                                f"twin's")
                        gate = (f"{var[1]} segment(s) of {var[0]} columns' "
                                f"codes and scales bit-identical to "
                                f"_quant_rows of the plain twin's output"
                                + (", the other columns' T too"
                                   if out is not None else " (codes only)"))
                else:
                    if dt == torch.bfloat16:
                        err, ulps = ulp_distance(out, want[0])
                        ok, gate = ulps <= ULPS, (f"{ulps:.2f} ulps from the "
                                                  f"plain twin")
                    else:
                        err = rel_err(out, want[0], 1.0)
                        ok, gate = err <= F32_OUT_REL, (
                            f"{err:.2e} of max(1, |plain|)")
                    if not ok:
                        raise AssertionError(f"(s) {what}: {gate} (limit "
                                             f"{ULPS} ulps / {F32_OUT_REL})")
                    if var:
                        oq, os_ = lq._quant_rows(out)
                        if not (torch.equal(got[1], oq)
                                and torch.equal(got[2], os_[:, 0])):
                            raise AssertionError(
                                f"(s) {what}: output codes or scales differ "
                                f"from _quant_rows of its own output")
                        gate += ", codes and scales exact"
                        del oq, os_
                held(kern + "_kernel", dt)
                del got, again, want, out
                # the same product on the exact kernel of dt, and _int_mm
                pair = lf.tf32_pair(w) if dt == torch.float32 else None
                if ln:
                    def exact():
                        return lf._gemm_res_ln(x, w, bias, res, gam, bet,
                                               pair=pair)
                else:
                    def exact():
                        return lf._gemm(x, w, bias, relu, pair=pair)
                ms = graph_ms(run)
                exact_ms = graph_ms(exact)
                plain_ms = cuda_ms(plain, iters=3) if timed_plain else 0.0
                try:
                    lib_ms = graph_ms(lambda: torch._int_mm(aq, wq))
                except RuntimeError:  # cuBLASLt: no int8 GEMM of this K
                    lib_ms = None
                size = 2 if dt == torch.bfloat16 else 4
                out_bytes = size * m * n
                if not ln and var:  # the segments as codes + scales
                    nc = var[0] * var[1]
                    out_bytes = (m * nc + 4 * var[1] * m
                                 + size * m * (n - nc) * var[2])
                nbytes_ = (m * k + 4 * m + n * k + 4 * n + size * n
                           + out_bytes)
                if ln:
                    nbytes_ += size * m * n + 8 * n
                    if var:
                        nbytes_ += m * n + 4 * m
                bd = bound(nbytes_, int8_ops=2 * m * k * n)
                variant = ("relu " if relu else "") + (
                    ("quant_out " if var else "") if ln else
                    (f"codes {var} " if var else ""))
                log(f"(s) {what} {variant}x{count}: {gate}; bit-identical "
                    f"reruns; kernel {ms:.3f} ms, bound "
                    f"{bd['bound_ms']:.3f} ms ({bd['bound_by']}, "
                    f"{bd['bound_ms'] / ms:.1%}), {nbytes_ / ms / 1e9:.2f} "
                    f"TB/s; {label_dt} kernel {exact_ms:.3f} ms, "
                    f"torch._int_mm "
                    + ("not supported" if lib_ms is None
                       else f"{lib_ms:.3f} ms")
                    + (f", plain twin {plain_ms:.3f} ms" if timed_plain
                       else ""))
                top = biggest.get((geo, label_dt, kern), (0.0, ""))
                if count * bd["bound_ms"] > top[0]:
                    biggest[geo, label_dt, kern] = (count * bd["bound_ms"],
                                                    bd["bound_by"])
                tot = totals.setdefault((geo, label_dt, kern),
                                        [0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
                for i, v in enumerate((1, ms, bd["bound_ms"], exact_ms,
                                       lib_ms, err, plain_ms)):
                    if i == 5:
                        tot[i] = max(tot[i], v)
                    elif tot[i] is not None:  # _int_mm: None if one is
                        tot[i] = None if v is None else tot[i] + count * v
                del x, w, aq, sa, wq, sw, wt, bias, res, pair
                torch.cuda.empty_cache()
    for (geo, label_dt, kern), (c, ms, bd, ex, lib, err, pl) in \
            totals.items():
        log(f"(s) {geo} {label_dt}: the forward's {c} {kern} launches "
            f"{ms:.3f} ms, bound {bd:.3f} ms ({bd / ms:.1%}), the "
            f"{label_dt} kernels of the same products {ex:.3f} ms, "
            f"torch._int_mm "
            + ("not supported" if lib is None else f"{lib:.3f} ms"))
        if geo == "paper b32" and label_dt == "bf16":
            summary[kern] = dict(launches=c, ms=ms, plain_ms=pl, bound_ms=bd,
                                 bound_by=biggest[geo, label_dt, kern][1],
                                 bf16_kernel_ms=ex, library_ms=lib,
                                 max_abs_err=err)
    if summary:
        ms = sum(v["ms"] for v in summary.values())
        bd = sum(v["bound_ms"] for v in summary.values())
        ex = sum(v["bf16_kernel_ms"] for v in summary.values())
        lib = sum(v["library_ms"] or math.nan for v in summary.values())
        log(f"(s) paper b32 bf16: the int8 forward's "
            f"{sum(v['launches'] for v in summary.values())} s8 GEMMs "
            f"{ms:.3f} ms (the mma.sync kernels they replaced "
            f"{Q8_GEMM_BEFORE_MS:.3f} ms, PERF.md), bound {bd:.3f} ms "
            f"({bd / ms:.1%}); the bf16 wgmma GEMMs of the same products "
            f"{ex:.3f} ms ({BF16_GEMM_MS:.3f} ms in (o)'s parent, PERF.md); "
            f"torch._int_mm {lib:.3f} ms")
    log(f"(s) done in {time.perf_counter() - t_phase:.1f} s; card {card}")
    return summary


# (t) K13's attention and quantizers alone ----------------------------------

# The attention kernel of the parent tree (mma.sync, its output in T for
# the row quantizer to read back) at the paper int8 forward's four
# attention shapes (gemm_ab.Q8_ATTENTION), bf16 (ms; tools/gemm_ab.py --q8,
# A B B A against it: PERF.md section 6, NVIDIA H100 80GB HBM3, 700 W)
Q8_ATTN_BEFORE_MS = {"freq self": 1.856, "time self": 0.449,
                     "decoder self": 0.495, "cross": 0.801}
# V's column quantizer of the parent tree (two reads of V) over the paper
# int8 forward's 11 launches, bf16 (ms; chip_smoke.py (t), PERF.md section
# 6: NVIDIA H100 80GB HBM3, 700 W)
Q8_COLS_BEFORE_MS = 3.950
# (label, hid, heads) of the widths (t) holds the attention at: the paper's
# (head_dim 64), the default model's and hid 96 over 3 heads (head_dim 32)
Q8_ATTN_WIDTHS = (("paper", 256, 4), ("default", 64, 2), ("hid 96", 96, 3))
# the FP32 operations of the softmax a score: the dequantizing products,
# s - m, the sum l, the P code's product (exp2 on the special-function
# units aside)
ATTN_SOFTMAX_FLOPS = 5


def check_k13_kernels(dev, card: str) -> dict:
    """(t): attention_q8_kernel alone at the four attention shapes of the
    paper int8 forward (``gemm_ab.Q8_ATTENTION``) at the paper widths, the
    default widths (head_dim 32) and hid 96 over 3 heads, in bf16 and f32,
    on the codes of seeded activations: its output in T (asked for here;
    the forward writes only the codes) under (k)'s attention gates (bf16:
    >= Q8_SHARE of the elements within ULPS bf16 ulps of
    ``attention_q8_plain``, all within Q8_BUDGET; f32: >= Q8_SHARE within
    Q8_F32_REL of max |plain|); its codes and scales those of
    ``_quant_rows`` of its own output, bit for bit, and those of the run
    that writes the codes only; its codes against the plain twin's: >=
    Q8_SHARE equal, all within 1; two runs bit-identical. Per shape the
    time (a CUDA graph of 20 calls) beside the bytes bound and the parent
    tree's kernel (Q8_ATTN_BEFORE_MS). Then quant_rows_kernel at the three
    inputs the forward still quantizes with it, bit for bit equal to its
    plain version, and quant_cols_kernel at the forward's V (strided views
    of the QKV and KV outputs, one column all zeros) at the paper, default
    and hid-96 widths in bf16 and f32, bit for bit ``quant_cols_plain``'s
    layout (zero codes past Lk included), reruns bit-identical; all
    timed.
    Returns the JSON rows' numbers of the three kernels: the paper batch-32
    bf16 forward's launches of each summed."""
    from nylon_amt_tpu_torch.ops import layer_fused_q8 as lq
    from nylon_amt_tpu_torch.ops.layer_fused import _scale
    from nylon_amt_tpu_torch.ops.precision import full_f32
    from nylon_amt_tpu_torch.tools.gemm_ab import (Q8_ATTENTION,
                                                   attention_q8_bytes,
                                                   graph_ms)

    t_phase = time.perf_counter()
    sums = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
                    library_ms=None) for k in Q8_KERNELS
            if k.startswith(("attention", "quant"))}
    before = 0.0
    for width, hid, heads in Q8_ATTN_WIDTHS:
        for dt in (torch.bfloat16, torch.float32):
            label_dt = "bf16" if dt == torch.bfloat16 else "f32"
            paper = width == "paper" and dt == torch.bfloat16
            for label, n, lq_, lk, count in Q8_ATTENTION:
                g = torch.Generator(device=dev).manual_seed(SEED + 23 + lk)
                q, k, v = (torch.randn((n, ln, hid), generator=g,
                                       device=dev).to(dt)
                           for ln in (lq_, lk, lk))
                qq, sq = lq._quant_rows(q)
                kq, sk = lq._quant_rows(k)
                vq, sv = lq._quant_cols(v)
                vt, svt = lq.quant_cols_cuda(v.reshape(-1, hid), n)
                args = (qq.reshape(-1, hid), sq.reshape(-1).contiguous(),
                        kq.reshape(-1, hid), sk.reshape(-1).contiguous(), vt,
                        svt, n, heads, dt)
                out, codes, scales = lq._attention_q8(*args, t_out=True)
                again = lq._attention_q8(*args, t_out=True)
                _, codes_only, scales_only = lq._attention_q8(*args)

                def plain():
                    with full_f32():
                        return lq.attention_q8_plain(
                            qq, sq, kq, sk, vq, sv, heads, _scale(hid, heads),
                            dt)
                pout, pc, ps = plain()
                torch.cuda.synchronize()
                what = (f"(t) attention_q8 {width} {label_dt} {label} "
                        f"[{n}, {lq_}, {lk}] hid {hid}/{heads}")
                pout, pc = pout.reshape(-1, hid), pc.reshape(-1, hid)
                if not (torch.equal(out, again[0])
                        and torch.equal(codes, again[1])
                        and torch.equal(scales, again[2])):
                    raise AssertionError(f"{what}: two runs differ")
                oq, os_ = lq._quant_rows(out)
                if not (torch.equal(codes, oq) and torch.equal(scales, os_[:, 0])
                        and torch.equal(codes_only, codes)
                        and torch.equal(scales_only, scales)):
                    raise AssertionError(
                        f"{what}: its codes or scales differ from "
                        f"_quant_rows of its own output, or from the "
                        f"codes-only run's")
                d = (out.float() - pout.float()).abs()
                tol = (ULPS * bf16_ulp(pout) if dt == torch.bfloat16
                       else Q8_F32_REL * pout.float().abs().max().item())
                share = (d <= tol).float().mean().item()
                err = d.max().item()
                cd = (codes.int() - pc.int()).abs()
                same = (cd == 0).float().mean().item()
                if not (share >= Q8_SHARE and err <= Q8_BUDGET
                        and same >= Q8_SHARE and cd.max().item() <= 1):
                    raise AssertionError(
                        f"{what}: {share:.6f} of the output within {tol:.2e} "
                        f"of attention_q8_plain (>= {Q8_SHARE}), max "
                        f"{err:.3e} (<= {Q8_BUDGET}); codes equal to the "
                        f"twin's {same:.6f} (>= {Q8_SHARE}), max difference "
                        f"{cd.max().item()} (<= 1)")
                del d, cd, oq, os_, again, out, pout, pc, ps
                ms = graph_ms(lambda: lq._attention_q8(*args))
                bd = bound(attention_q8_bytes(n, lq_, lk, hid),
                           int8_ops=4 * n * lq_ * lk * hid,
                           f32_flops=ATTN_SOFTMAX_FLOPS * n * heads * lq_ * lk)
                old = Q8_ATTN_BEFORE_MS[label] if paper else math.nan
                log(f"{what}: output {share:.6f} within {tol:.2e} of the "
                    f"plain twin, max {err:.3e}; codes = _quant_rows of its "
                    f"output, bit for bit, {same:.6f} equal to the twin's "
                    f"(all within 1); bit-identical reruns; {ms:.3f} ms, "
                    f"bound {bd['bound_ms']:.3f} ms ({bd['bound_by']}, "
                    f"{bd['bound_ms'] / ms:.1%})"
                    + (f", the parent tree's kernel {old:.3f} ms (PERF.md)"
                       if paper else "") + f" x{count}")
                held("attention_q8_kernel", dt, hid // heads)
                if paper:
                    row = sums["attention_q8_kernel"]
                    row["ms"] += count * ms
                    row["plain_ms"] += count * cuda_ms(plain, iters=2)
                    row["bound_ms"] += count * bd["bound_ms"]
                    row["max_abs_err"] = max(row["max_abs_err"], err)
                    row["bound_by"] = bd["bound_by"]
                    before += count * old
                del q, k, v, qq, sq, kq, sk, vq, sv, vt, svt, args
                torch.cuda.empty_cache()
    row = sums["attention_q8_kernel"]
    log(f"(t) the paper int8 forward's 11 attention launches (bf16): "
        f"{row['ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
        f"({row['bound_ms'] / row['ms']:.1%}), the parent tree's kernel "
        f"{before:.3f} ms (PERF.md), the plain twin {row['plain_ms']:.3f} ms")

    # the row quantizer at the inputs the forward still gives it (the
    # stem's output, the note queries, the first time layer's input) and
    # V's quantizer at the forward's V (a column slice of the QKV / KV
    # output), paper widths, bf16
    g = torch.Generator(device=dev).manual_seed(SEED + 29)
    hid = 256
    rows_in = (BATCH * 128 * 256, BATCH * 128 * 88, BATCH * 88 * 128)
    for m_ in rows_in:
        x = torch.randn((m_, hid), generator=g, device=dev).to(torch.bfloat16)
        q, sc = lq.quant_rows_cuda(x)
        pq, ps = lq._quant_rows(x)
        if not (torch.equal(q, pq) and torch.equal(sc, ps[:, 0])):
            raise AssertionError(f"(t) quant_rows [{m_}, {hid}] differs")
        row = sums["quant_rows_kernel"]
        row["ms"] += graph_ms(lambda: lq.quant_rows_cuda(x))
        row["plain_ms"] += cuda_ms(lambda: lq._quant_rows(x), iters=3)
        bd = bound(m_ * hid * 3 + 4 * m_)
        row["bound_ms"] += bd["bound_ms"]
        row["bound_by"] = bd["bound_by"]
        del x, q, sc, pq, ps
    # V's quantizer at every width of Q8_ATTN_WIDTHS in bf16 and f32, on V's
    # strided view with one all-zero column (the floored scale), against
    # quant_cols_plain's layout in full (zero codes past Lk included)
    for width, hid_, _ in Q8_ATTN_WIDTHS:
        for dt in (torch.bfloat16, torch.float32):
            paper = width == "paper" and dt == torch.bfloat16
            label_dt = "bf16" if dt == torch.bfloat16 else "f32"
            tot = dict(ms=0.0, bound_ms=0.0)
            for label, n, _, lk, count in Q8_ATTENTION:
                width_ = 3 if label.endswith("self") else 2  # QKV or KV
                x = torch.randn((n * lk, width_ * hid_), generator=g,
                                device=dev).to(dt)
                v = x[:, (width_ - 1) * hid_:]
                v[:, 7] = 0
                vt, sv = lq.quant_cols_cuda(v, n)
                again = lq.quant_cols_cuda(v, n)
                pv, psv = lq.quant_cols_plain(v, n)
                if not (torch.equal(vt, pv) and torch.equal(sv, psv)
                        and torch.equal(vt, again[0])
                        and torch.equal(sv, again[1])):
                    raise AssertionError(f"(t) quant_cols {width} "
                                         f"{label_dt} of {label} differs "
                                         f"from quant_cols_plain or between "
                                         f"runs")
                ms = graph_ms(lambda: lq.quant_cols_cuda(v, n))
                bd = bound(n * lk * hid_ * v.element_size() + vt.numel()
                           + 4 * sv.numel())
                tot["ms"] += count * ms
                tot["bound_ms"] += count * bd["bound_ms"]
                log(f"(t) quant_cols_kernel {width} {label_dt} {label} "
                    f"[{n} x {lk}, {hid_}] (row stride {v.stride(0)}): "
                    f"codes and scales bit for bit quant_cols_plain's, "
                    f"reruns bit-identical; {ms:.3f} ms, bound "
                    f"{bd['bound_ms']:.3f} ms ({bd['bound_ms'] / ms:.1%}) "
                    f"x{count}")
                if paper:
                    row = sums["quant_cols_kernel"]
                    row["ms"] += count * ms
                    row["plain_ms"] += count * cuda_ms(
                        lambda: lq.quant_cols_plain(v, n), iters=3)
                    row["bound_ms"] += count * bd["bound_ms"]
                    row["bound_by"] = bd["bound_by"]
                del x, v, vt, sv, pv, psv, again
                torch.cuda.empty_cache()
            held("quant_cols_kernel", dt)
            log(f"(t) quant_cols_kernel {width} {label_dt}, the int8 "
                f"forward's 11 launches: {tot['ms']:.3f} ms, bound "
                f"{tot['bound_ms']:.3f} ms "
                f"({tot['bound_ms'] / tot['ms']:.1%})"
                + (f"; the parent tree's kernel {Q8_COLS_BEFORE_MS:.3f} ms "
                   f"(PERF.md)" if paper else ""))
    for k in ("quant_rows_kernel", "quant_cols_kernel"):
        held(k, torch.bfloat16)
        row = sums[k]
        log(f"(t) {k} at the paper int8 forward's launches (bf16): bit for "
            f"bit equal to the plain version; {row['ms']:.3f} ms, bound "
            f"{row['bound_ms']:.3f} ms ({row['bound_ms'] / row['ms']:.1%}), "
            f"plain {row['plain_ms']:.3f} ms")
    log(f"(t) done in {time.perf_counter() - t_phase:.1f} s; card {card}")
    return sums


# (u) the LayerNorm backward alone --------------------------------------------

# The steps whose launches (u) runs: (label, compute dtype, config): the
# paper bf16 step of (j) and the default f32 step of (n), batch TRAIN_BATCH
LN_STEPS = (("paper bf16 (j)", torch.bfloat16, "paper"),
            ("default f32 (n)", torch.float32, "default"))
# the parent tree's ln_bwd_kernel over (j)'s 20 launches (ms: PR 15's (j)
# profile, PERF.md section 6; NVIDIA H100 80GB HBM3, 700 W)
LN_BWD_BEFORE_MS = 5.636
LN_F32_REL = 2e-5   # f32 da / dam, of max(1, max |plain|)
LN_SUM_REL = 1e-4   # dgamma / dbeta, of max |plain|


def check_ln_bwd(dev, card: str, launches: dict) -> dict:
    """(u): ln_bwd_kernel alone at every launch shape of (j)'s paper bf16
    step and (n)'s default f32 step, with the steps' dropout site (rate
    RATE) and without: da and dam within ULPS bf16 ulps of
    ``ln_bwd_plain`` (f32: LN_F32_REL of max(1, max |plain|)), dam bit for
    bit T(da x keep) of the kernel's own da, dgamma and dbeta within
    LN_SUM_REL of max |plain|, reruns bit-identical. Each shape timed by a
    CUDA graph of the kernel's call beside its bytes bound, the plain twin
    and, without dropout, ``torch.ops.aten.native_layer_norm_backward``
    (handed mean and rstd; the library computes no keep mask).
    ``launches``: each step's count of ln_bwd launches from (j) and (n),
    which the shapes must add up to. Returns the JSON row: the paper
    step's launches (all with their dropout site) summed, the default
    step's beside it."""
    from nylon_amt_tpu_torch import Config, ModelConfig
    from nylon_amt_tpu_torch.ops import layer_fused as lf
    from nylon_amt_tpu_torch.ops import layer_fused_train as tlt
    from nylon_amt_tpu_torch.tools.gemm_ab import graph_ms, ln_step_shapes

    t_phase = time.perf_counter()
    rows = {}
    for label, dt, which in LN_STEPS:
        m_cfg = ModelConfig.paper_scale() if which == "paper" \
            else Config().model
        n = m_cfg.hid_dim
        shapes = ln_step_shapes(m_cfg)
        if sum(c for _, c in shapes) != launches[label]:
            raise AssertionError(f"(u) {label}: shapes {shapes}, the step's "
                                 f"launches {launches[label]}")
        tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
                   nodrop_ms=0.0, library_ms=0.0, bound_by="bytes")
        for m, count in shapes:
            g = torch.Generator(device=dev).manual_seed(SEED + 31 + m + n)
            dy = torch.randn((m, n), generator=g, device=dev).to(dt)
            s = (3 * torch.randn((m, n), generator=g, device=dev)
                 + 0.5).to(dt)
            gamma = 1 + 0.1 * torch.randn(n, generator=g, device=dev)
            for drop in (False, True):
                site = (tlt._site(DROP_SEED, tlt._SITE_FFN_OUT, n, RATE, dt)
                        if drop else None)
                got = tlt.ln_bwd_cuda(dy, s, gamma, site)
                again = tlt.ln_bwd_cuda(dy, s, gamma, site)
                want = tlt.ln_bwd_plain(dy, s, gamma, site)
                torch.cuda.synchronize()
                what = (f"(u) ln_bwd_kernel {label} [{m}, {n}] "
                        f"{'with' if drop else 'without'} a dropout site")
                if not all(a is b or torch.equal(a, b)
                           for a, b in zip(got, again)):
                    raise AssertionError(f"{what}: two runs differ")
                errs = []
                for a, b in zip(got[:2], want[:2]):
                    if b is None:
                        continue
                    if dt == torch.bfloat16:
                        err, ulps = ulp_distance(a, b)
                        ok = ulps <= ULPS
                        errs.append(f"{ulps:.2f} ulps")
                    else:
                        err = (a - b).abs().max().item()
                        rel = err / max(1.0, b.abs().max().item())
                        ok = rel <= LN_F32_REL
                        errs.append(f"{rel:.2e} of max(1, |plain|)")
                    if not ok:
                        raise AssertionError(f"{what}: da / dam {errs} from "
                                             f"ln_bwd_plain")
                    tot["max_abs_err"] = max(tot["max_abs_err"], err)
                if drop and not torch.equal(
                        got[1], (got[0] * lf._site_mask(site, got[0]))
                        .to(dt)):
                    raise AssertionError(f"{what}: dam is not T(da x keep) "
                                         f"of the kernel's own da")
                sums = [rel_err(a, b) for a, b in zip(got[2:], want[2:])]
                if not max(sums) <= LN_SUM_REL:
                    raise AssertionError(f"{what}: dgamma / dbeta {sums} of "
                                         f"max |plain| (<= {LN_SUM_REL})")
                ln = tlt._LnGrads(m, n, 1, dev, dt)

                def kernel():
                    ln.used = 0
                    tlt._ln_backward(dy, s, gamma, site, ln)
                ms = graph_ms(kernel)
                plain_ms = cuda_ms(lambda: tlt.ln_bwd_plain(dy, s, gamma,
                                                            site), iters=2)
                bd = bound(nbytes(dy, s, gamma, *got[:2 if drop else 1])
                           + 2 * 4 * ln.blocks * n)
                lib = ""
                if drop:
                    tot["ms"] += count * ms
                    tot["plain_ms"] += count * plain_ms
                    tot["bound_ms"] += count * bd["bound_ms"]
                else:
                    w = gamma.to(dt)
                    zero = torch.zeros_like(w)
                    _, mean, rstd = torch.ops.aten.native_layer_norm(
                        s, [n], w, zero, lf._LN_EPS)
                    lib_ms = graph_ms(
                        lambda: torch.ops.aten.native_layer_norm_backward(
                            dy, s, [n], mean, rstd, w, zero,
                            [True, True, True]))
                    tot["nodrop_ms"] += count * ms
                    tot["library_ms"] += count * lib_ms
                    lib = (f", native_layer_norm_backward {lib_ms:.3f} ms "
                           f"({lib_ms / ms:.2f}x the kernel's)")
                log(f"{what}: da/dam {', '.join(errs)} from ln_bwd_plain"
                    + (", dam T(da x keep) bit for bit" if drop else "")
                    + f", dgamma/dbeta {max(sums):.1e} of max |plain|; "
                    f"reruns bit-identical; {ms:.3f} ms, bound "
                    f"{bd['bound_ms']:.3f} ms ({bd['bound_ms'] / ms:.1%}), "
                    f"plain {plain_ms:.3f} ms{lib}; {ln.blocks} blocks of "
                    f"{ln.rows} rows a tile x{count}")
                del got, again, want
            held("ln_bwd_kernel", dt)
            del dy, s, gamma
            torch.cuda.empty_cache()
        rows[label] = dict(tot, launches=launches[label])
        log(f"(u) {label}, its {launches[label]} ln_bwd launches: "
            f"{tot['ms']:.3f} ms, bound {tot['bound_ms']:.3f} ms "
            f"({tot['bound_ms'] / tot['ms']:.1%}), plain "
            f"{tot['plain_ms']:.3f} ms; without dropout {tot['nodrop_ms']:.3f}"
            f" ms against native_layer_norm_backward "
            f"{tot['library_ms']:.3f} ms"
            + (f"; the parent tree's kernel {LN_BWD_BEFORE_MS:.3f} ms "
               f"(PERF.md)" if which == "paper" else ""))
    log(f"(u) done in {time.perf_counter() - t_phase:.1f} s; card {card}")
    paper, default = (rows[label] for label, _, _ in LN_STEPS)
    return dict({k: paper[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "max_abs_err",
                                       "library_ms")},
                nodrop_ms=paper["nodrop_ms"], default_f32_step={
                    k: default[k] for k in ("launches", "ms", "plain_ms",
                                            "bound_ms", "nodrop_ms",
                                            "library_ms")})


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
    from nylon_amt_tpu_torch.tools.gemm_ab import ln_step_shapes
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
    # the wgmma / TMA GEMMs of csrc/layer_fused.cu, layer_fused_train.cu and
    # layer_fused_f32.cu: no spills, no stack, and (where the toolkit has
    # cuobjdump) wgmma and TMA loads in their SASS
    gemms = gemm_ptxas((kernels.build_dir() / "build.log").read_text())
    spilled = {k: v for k, v in gemms.items() if v["spill"] or v["stack"]}
    unbalanced = {k: v for k, v in gemms.items()
                  if v["kernel"] in SETMAXNREG_KERNELS and v["regs"] != 168}
    if {v["kernel"] for v in gemms.values()} != set(GEMM_KERNELS) \
            or spilled or unbalanced:
        raise AssertionError(f"(a) GEMM kernels in ptxas -v: {gemms}")
    log(f"(a) {len(gemms)} instantiations of {', '.join(GEMM_KERNELS)}: no "
        f"spills, no stack, {min(v['regs'] for v in gemms.values())}-"
        f"{max(v['regs'] for v in gemms.values())} registers")
    rings = gemm_ptxas((kernels.build_dir() / "build.log").read_text(),
                       tuple(RING_KERNELS))
    if {v["kernel"] for v in rings.values()} != set(RING_KERNELS) or any(
            v["spill"] or v["stack"] for v in rings.values()):
        raise AssertionError(f"(a) the TMA-ring kernels in ptxas -v: {rings}")
    log(f"(a) {len(rings)} instantiations of {', '.join(RING_KERNELS)}: no "
        f"spills, no stack, " + ", ".join(
            f"{v['kernel']} {v['regs']}" for v in rings.values())
        + " registers")
    q8_gemms = gemm_ptxas((kernels.build_dir() / "build.log").read_text(),
                          Q8_WGMMA_KERNELS)
    if {v["kernel"] for v in q8_gemms.values()} != set(Q8_WGMMA_KERNELS) \
            or any(v["spill"] or v["stack"] for v in q8_gemms.values()) \
            or any(v["regs"] != 168 for v in q8_gemms.values()
                   if v["kernel"] == "gemm_q8_bias_kernel"):
        raise AssertionError(f"(a) the s8 GEMMs and attention in ptxas -v: "
                             f"{q8_gemms}")
    log(f"(a) {len(q8_gemms)} instantiations of "
        f"{', '.join(Q8_WGMMA_KERNELS)}: no spills, no stack, "
        + ", ".join(f"{k} " + "/".join(str(v["regs"]) for v in
                                      q8_gemms.values() if v["kernel"] == k)
                    for k in Q8_WGMMA_KERNELS) + " registers")
    mha = gemm_ptxas((kernels.build_dir() / "build.log").read_text(),
                     MHA_KERNELS)
    if {v["kernel"] for v in mha.values()} != set(MHA_KERNELS) \
            or len(mha) != MHA_INSTANTIATIONS \
            or any(v["spill"] or v["stack"] for v in mha.values()):
        raise AssertionError(f"(a) the bf16 attention kernels in ptxas -v "
                             f"({len(mha)} of {MHA_INSTANTIATIONS}): {mha}")
    log(f"(a) {len(mha)} instantiations of {', '.join(MHA_KERNELS)}: no "
        f"spills, no stack, " + ", ".join(
            f"{k} " + "-".join(str(f(v["regs"] for v in mha.values()
                                     if v["kernel"] == k)) for f in (min, max))
            for k in MHA_KERNELS) + " registers")
    mha32 = gemm_ptxas((kernels.build_dir() / "build.log").read_text(),
                       MHA_F32_KERNELS)
    if {v["kernel"] for v in mha32.values()} != set(MHA_F32_KERNELS) \
            or len(mha32) != MHA_F32_INSTANTIATIONS \
            or any(v["spill"] or v["stack"] for v in mha32.values()):
        raise AssertionError(f"(a) the f32 attention kernels in ptxas -v "
                             f"({len(mha32)} of {MHA_F32_INSTANTIATIONS}): "
                             f"{mha32}")
    log(f"(a) {len(mha32)} instantiations of {', '.join(MHA_F32_KERNELS)}: "
        f"no spills, no stack, " + ", ".join(
            f"{k} " + "-".join(str(f(v["regs"] for v in mha32.values()
                                     if v["kernel"] == k)) for f in (min, max))
            for k in MHA_F32_KERNELS) + " registers")
    stream = gemm_ptxas((kernels.build_dir() / "build.log").read_text(),
                        STREAM_KERNELS)
    if {v["kernel"] for v in stream.values()} != set(STREAM_KERNELS) \
            or len(stream) != STREAM_INSTANTIATIONS \
            or any(v["spill"] or v["stack"] for v in stream.values()):
        raise AssertionError(f"(a) the streaming kernels in ptxas -v "
                             f"({len(stream)} of {STREAM_INSTANTIATIONS}): "
                             f"{stream}")
    log(f"(a) {len(stream)} instantiations of {', '.join(STREAM_KERNELS)}: "
        f"no spills, no stack, " + ", ".join(
            f"{k} " + "-".join(str(f(v["regs"] for v in stream.values()
                                     if v["kernel"] == k)) for f in (min, max))
            for k in STREAM_KERNELS) + " registers")
    sass_proc = start_sass(kernels.build_dir() / kernels.LIB_NAME)
    if sass_proc is None:
        log("(a) no cuobjdump beside nvcc: the GEMMs' SASS is not checked")

    # (b) K1 log-mel ------------------------------------------------------------
    # The f32 DFT of the lowest mel bins of zero-mean audio is a sum with
    # heavy cancellation: there, any two f32 summation orders (the kernel's
    # and cuBLAS's) differ by more than 2e-4 in log-mel. So the kernel is
    # held within 2e-4 of a float64 truth, on the smoke's audio, on a quiet
    # variant (noise floor 0.01), where the cancellation is worst, and on 10
    # s of other audio (fewer blocks than the card holds at once).
    cfg = Config(model=dataclasses.replace(ModelConfig.paper_scale(),
                                           compute_dtype="bfloat16"))
    fe = MelFrontend(cfg.feature, dev)
    audio = synth_audio(AUDIO_SEC, rng)
    quiet = synth_audio(AUDIO_SEC, np.random.default_rng(SEED + 1), 0.01)
    short = synth_audio(10.0, np.random.default_rng(SEED + 2))
    k1 = {}
    for label, samples in (("main", audio), ("quiet", quiet),
                           ("short", short)):
        w = torch.from_numpy(samples).to(dev)
        got = log_mel(w, fe)
        again = log_mel(w, fe)
        ref = log_mel_plain(w, fe)
        frames = fe.frame(w).double()
        re, im = frames @ fe.cos_w.double().T, frames @ fe.sin_w.double().T
        ref64 = torch.log((re * re + im * im) @ fe.fb.double()
                          + cfg.feature.log_offset)
        del frames, re, im
        err64 = (got.double() - ref64).abs().max().item()
        k1[label] = dict(
            err64=err64, plain_err64=(ref.double() - ref64).abs().max().item(),
            diff=(got - ref).abs().max().item(), frames=got.shape[0])
        if got.shape != ref64.shape or not err64 <= K1_ATOL:
            raise AssertionError(f"K1 log_mel ({label} audio): shape "
                                 f"{tuple(got.shape)} vs {tuple(ref.shape)}, "
                                 f"{err64} from float64 (atol {K1_ATOL})")
        if not torch.equal(got, again):
            raise AssertionError(f"K1 log_mel ({label} audio): two runs "
                                 f"differ")
    held("log_mel", torch.float32)
    wav = torch.from_numpy(audio).to(dev)
    got = log_mel(wav, fe)
    ms = cuda_ms(lambda: log_mel(wav, fe), iters=10)
    plain_ms = cuda_ms(lambda: log_mel_plain(wav, fe), iters=10)
    w_short = torch.from_numpy(short).to(dev)
    short_ms = cuda_ms(lambda: log_mel(w_short, fe), iters=10)
    # the work the function needs: the DFT of the bins from the first to
    # the last filterbank row with mel weight (f64), then their power and
    # the gather of the filterbank's non-zeros (f32)
    n_fft = fe.cos_w.shape[1]
    t_frames, n_mels = got.shape
    weighted = fe.fb != 0
    rows = weighted.any(1).nonzero().flatten().tolist()
    n_bins = rows[-1] - rows[0] + 1
    nnz = int(weighted.sum())
    results["log_mel"] = dict(
        max_abs_err=k1["main"]["err64"], ms=ms, plain_ms=plain_ms,
        **bound(nbytes(wav, got, *fe.kernel_bases),
                f64_flops=2 * 2 * t_frames * n_fft * n_bins,
                f32_flops=t_frames * (3 * n_bins + 2 * nnz)),
        library_ms=None,
        gate=f"atol {K1_ATOL} from float64 (main {k1['main']['err64']:.3e}, "
             f"quiet {k1['quiet']['err64']:.3e}, short "
             f"{k1['short']['err64']:.3e}); reruns bit-identical")
    for label, r in k1.items():
        log(f"(b) K1 log_mel, {label} audio -> [{r['frames']}, {n_mels}]: "
            f"from float64 kernel {r['err64']:.3e} (atol {K1_ATOL}), plain "
            f"f32 {r['plain_err64']:.3e}; kernel vs plain {r['diff']:.3e}; "
            f"bit-identical reruns")
    log(f"(b) K1 log_mel, {AUDIO_SEC:.0f} s: kernel {ms:.3f} ms, bound "
        f"{results['log_mel']['bound_ms']:.3f} ms "
        f"({results['log_mel']['bound_ms'] / ms:.1%}; bins {rows[0]}.."
        f"{rows[-1]}, {nnz} filterbank non-zeros), plain f32 "
        f"{plain_ms:.3f} ms, the CUDA-core kernel it replaced "
        f"{K1_SIMT_MS:.3f} ms (PERF.md); 10 s: kernel {short_ms:.3f} ms; "
        f"card {card}")

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
    fused_step_ms, step_counts = time_train_step(cfg, first_batch, dev, card)
    want = sum(c for _, c in ln_step_shapes(m))
    if step_counts["ln_bwd"] != want:
        raise AssertionError(f"(j) the step's ln_bwd launches "
                             f"{step_counts['ln_bwd']}, expected {want}")

    # (k) K13, the int8 layers -------------------------------------------------
    q8_counts, q8_results, k13_profile = check_int8(
        cfg, model, packed, spec, audio, dev, card, cli_main)
    results.update(q8_results)
    q8_gemm_launches = {k.removesuffix("_kernel"): k13_profile[k][1]
                        for k in Q8_GEMM_KERNELS}

    # (l) K10 / K11 / K12, the per-site attention ---------------------------
    results.update(check_attention_kernels(dev))
    check_return_attention_forward(cfg, model, packed, spec, dev, fwd_ms)
    mha_counts, _ = per_site_through_cli(cfg, feat, audio, dev, card,
                                         cli_main)
    rep = dataclasses.replace
    for name, over in (("--remat", dict(remat=True)),
                       ("1FLT", dict(dec_alg="linear_satime")),
                       ("2FDT", dict(enc_alg="cnnblock_safreq"))):
        ms, _ = time_train_step(rep(cfg, model=rep(cfg.model, **over)),
                                first_batch, dev, card, phase="l",
                                what=f"{name} per-site ")
        log(f"(l) {name} per-site train step {ms:.3f} ms against (j)'s fused "
            f"step {fused_step_ms:.3f} ms ({ms / fused_step_ms:.2f}x)")

    # (m) head_dim 32: the default configuration ---------------------------
    check_default_config(feat, audio, spec, dev, card, cli_main)

    # (n) the default Config() in float32 ----------------------------------
    f32_times, f32_counts = check_float32(feat, audio, spec, dev, card,
                                          cli_main)

    # (o) the bf16 layer GEMMs alone ---------------------------------------
    check_gemms(dev, card)

    # (p) the bf16 backward GEMMs alone ------------------------------------
    check_bwd_gemms(dev, card)

    # (q) the f32 layer GEMMs alone -----------------------------------------
    gemm32 = ("gemm_bias_f32", "gemm_res_ln_f32", "gemm_bias_ffma_f32")
    q_rows = check_gemms_f32(dev, card)
    q_counts = {k: row.pop("launches") for k, row in q_rows.items()}
    if q_counts != {k: f32_counts[k] for k in gemm32}:
        raise AssertionError(f"(q) the paper batch-32 forward's GEMM cases "
                             f"{q_counts}, (n.4)'s launches {f32_counts}")
    results.update(q_rows)
    for name in gemm32:
        held(name, torch.float32)

    # (r) the f32 backward GEMMs alone ---------------------------------------
    bwd32 = ("gemm_nt_f32", "wgrad_f32")
    r_rows = check_bwd_gemms_f32(dev, card)
    r_counts = {key: row.pop("launches") for key, row in r_rows.items()}
    want = {**{("default b8", k): f32_counts[k] for k in bwd32},
            **{("paper b8", k): f32_counts[f"{k}/paper"] for k in bwd32}}
    if r_counts != want or not all(r_counts.values()):
        raise AssertionError(f"(r) the steps' dX / dW cases {r_counts}, the "
                             f"launches of (n)'s default step and of (n.2)'s "
                             f"paper layers {want}")
    for k in bwd32:  # the default step's row, the paper step's beside it
        paper_row = r_rows[("paper b8", k)]
        results[k] = dict(r_rows[("default b8", k)], paper_step={
            "launches": want[("paper b8", k)], **{k_: paper_row[k_] for k_ in (
                "ms", "plain_ms", "library_ms", "bound_ms")}})
    for name in bwd32:
        held(name, torch.float32)

    # (s) the int8 layer GEMMs alone -------------------------------------------
    s8 = check_gemms_q8(dev, card)
    s8_cases = {k: v.pop("launches") for k, v in s8.items()}
    if s8_cases != q8_gemm_launches or not all(s8_cases.values()):
        raise AssertionError(f"(s) the paper batch-32 int8 forward's GEMM "
                             f"cases {s8_cases}, (k)'s profiled launches "
                             f"{q8_gemm_launches}")
    for k, v in s8.items():
        v["launches"] = q8_gemm_launches[k]
    s8_row = dict(  # the paper batch-32 int8 forward's s8 GEMMs, summed
        launches=sum(q8_gemm_launches.values()),
        ms=sum(v["ms"] for v in s8.values()),
        bound_ms=sum(v["bound_ms"] for v in s8.values()),
        bf16_kernel_ms=sum(v["bf16_kernel_ms"] for v in s8.values()),
        library_ms=None if any(v["library_ms"] is None for v in s8.values())
        else sum(v["library_ms"] for v in s8.values()), by_kernel=s8)
    for name in Q8_SOURCES:
        results[name]["s8_gemms"] = s8_row

    # (t) K13's attention and quantizers alone ---------------------------------
    k13_rows = check_k13_kernels(dev, card)
    for k in Q8_GEMM_KERNELS:
        row = dict(s8[k.removesuffix("_kernel")])
        row.pop("launches")
        k13_rows[k] = row

    # (u) the LayerNorm backward alone -------------------------------------
    results["ln_bwd_kernel"] = check_ln_bwd(dev, card, {
        "paper bf16 (j)": step_counts["ln_bwd"],
        "default f32 (n)": f32_counts["ln_bwd/default"]})
    if sass_proc is not None:  # (a)'s SASS check, run in the background
        sass = gemm_sass(sass_proc, kernels.build_dir() / kernels.LIB_NAME)
        bad = {k: v for k, v in sass.items()
               if not v["HGMMA"] or not v["UTMALDG"]}
        if len(sass) != len(gemms) or bad:
            raise AssertionError(f"(a) GEMM SASS: {len(sass)} kernels of "
                                 f"{len(gemms)}, without HGMMA or UTMALDG: "
                                 f"{bad}")
        log(f"(a) SASS of the {len(sass)} GEMM kernels (cuobjdump): HGMMA "
            f"{min(v['HGMMA'] for v in sass.values())}-"
            f"{max(v['HGMMA'] for v in sass.values())}, UTMALDG "
            f"{min(v['UTMALDG'] for v in sass.values())}-"
            f"{max(v['UTMALDG'] for v in sass.values())} a kernel")
        sass = gemm_sass(sass_proc, kernels.build_dir() / kernels.LIB_NAME,
                         tuple(RING_KERNELS), ("DMMA", "FFMA", "UTMALDG"))
        want = {k: next(op for n, op in RING_KERNELS.items() if n in k)
                for k in sass}
        if len(sass) != len(rings) or any(
                not v[want[k]] or not v["UTMALDG"] for k, v in sass.items()):
            raise AssertionError(f"(a) SASS of the TMA-ring kernels: {sass}")
        log("(a) SASS of the TMA-ring kernels (cuobjdump): " + "; ".join(
            f"{rings[k]['kernel'] if k in rings else k[:40]}: "
            f"{want[k]} {v[want[k]]}, UTMALDG {v['UTMALDG']}"
            for k, v in sass.items()))
        sass = gemm_sass(sass_proc, kernels.build_dir() / kernels.LIB_NAME,
                         Q8_WGMMA_KERNELS, ("IGMMA", "UTMALDG", "IMMA"))
        if len(sass) != len(q8_gemms) or any(
                not v["IGMMA"] or not v["UTMALDG"] or v["IMMA"]
                for v in sass.values()):
            raise AssertionError(f"(a) SASS of the s8 GEMMs and attention: "
                                 f"{sass}")
        mha_sass = gemm_sass(sass_proc, kernels.build_dir()
                             / kernels.LIB_NAME, MHA_KERNELS,
                             ("HGMMA", "UTMALDG", "HMMA"))
        if len(mha_sass) != len(mha) or any(
                not v["HGMMA"] or not v["UTMALDG"] or v["HMMA"]
                for v in mha_sass.values()):
            raise AssertionError(f"(a) SASS of the bf16 attention: "
                                 f"{mha_sass}")
        mha32_sass = gemm_sass(sass_proc, kernels.build_dir()
                               / kernels.LIB_NAME, MHA_F32_KERNELS,
                               ("HGMMA", "UTMALDG", "HMMA"))
        if len(mha32_sass) != len(mha32) or any(
                not v["HGMMA"] or not v["UTMALDG"] or v["HMMA"]
                for v in mha32_sass.values()):
            raise AssertionError(f"(a) SASS of the f32 attention: "
                                 f"{mha32_sass}")
        stream_sass = gemm_sass(sass_proc, kernels.build_dir()
                                / kernels.LIB_NAME, STREAM_KERNELS,
                                ("UTMALDG",))
        if len(stream_sass) != len(stream) or any(
                not v["UTMALDG"] for v in stream_sass.values()):
            raise AssertionError(f"(a) SASS of the streaming kernels: "
                                 f"{stream_sass}")
        log(f"(a) SASS of the {len(stream_sass)} streaming kernels "
            f"(cuobjdump): UTMALDG in each")
        log(f"(a) SASS of the {len(mha32_sass)} f32 attention kernels "
            f"(cuobjdump): HGMMA "
            f"{min(v['HGMMA'] for v in mha32_sass.values())}-"
            f"{max(v['HGMMA'] for v in mha32_sass.values())}, UTMALDG "
            f"{min(v['UTMALDG'] for v in mha32_sass.values())}-"
            f"{max(v['UTMALDG'] for v in mha32_sass.values())} a kernel, no "
            f"HMMA (mma.sync)")
        log(f"(a) SASS of the {len(mha_sass)} bf16 attention kernels "
            f"(cuobjdump): HGMMA "
            f"{min(v['HGMMA'] for v in mha_sass.values())}-"
            f"{max(v['HGMMA'] for v in mha_sass.values())}, UTMALDG "
            f"{min(v['UTMALDG'] for v in mha_sass.values())}-"
            f"{max(v['UTMALDG'] for v in mha_sass.values())} a kernel, no "
            f"HMMA (mma.sync)")
        log(f"(a) SASS of the {len(sass)} s8 GEMM and attention kernels "
            f"(cuobjdump): IGMMA {min(v['IGMMA'] for v in sass.values())}-"
            f"{max(v['IGMMA'] for v in sass.values())}, UTMALDG "
            f"{min(v['UTMALDG'] for v in sass.values())}-"
            f"{max(v['UTMALDG'] for v in sass.values())} a kernel, no IMMA "
            f"(mma.sync)")

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
    # K13's CUDA kernels: launches of (k)'s profiled paper int8 forward,
    # whose shapes (s) and (t) timed
    counts.update({k: k13_profile[k][1] for k in Q8_KERNELS})
    results.update(k13_rows)
    sources.update({k: ("layer_fused_q8.cu", Q8_SOURCES["encoder_layer_q8"])
                    for k in Q8_KERNELS})
    counts.update(mha_counts)
    # the f32 GEMM kernels: launches of (n.4)'s paper f32 forward, whose
    # shapes (q) timed
    counts.update({k: f32_counts[k] for k in gemm32})
    sources.update({k: ("layer_fused_f32.cu",
                        "nylon_amt_tpu/ops/layer_fused.py:301")
                    for k in gemm32[:2]})
    sources["gemm_bias_ffma_f32"] = ("layer_fused_f32.cu",
                                     "nylon_amt_tpu/ops/layer_fused.py:376")
    # the f32 dX / dW GEMMs: launches of (n)'s default f32 train step, whose
    # shapes (r) timed; the dot_generals of the backward kernels K7-K9
    counts.update({k: f32_counts[k] for k in bwd32})
    sources.update({k: ("layer_fused_f32.cu", f"{train}:472")
                    for k in bwd32})
    # the LayerNorm backward of K7-K9 (the encoder's pallas_call line; the
    # decoders' is f"{train}:789"): launches of (j)'s paper bf16 step, whose
    # shapes (u) timed
    counts["ln_bwd_kernel"] = step_counts["ln_bwd"]
    sources["ln_bwd_kernel"] = ("layer_fused_train.cu", f"{train}:472")
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
        **{n: ["layer_fused_q8.cu"] for n in (*Q8_SOURCES, *Q8_KERNELS)},
        **{n: ["layer_fused_f32.cu"] for n in gemm32},
        "gemm_nt_f32": ["layer_fused_f32.cu"],
        "ln_bwd_kernel": ["layer_fused_train.cu"],
        "wgrad_f32": ["layer_fused_f32.cu", "layer_fused_train.cu"]}
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
