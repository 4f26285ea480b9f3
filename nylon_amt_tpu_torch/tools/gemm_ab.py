"""A/B two or more builds of the layer GEMMs in one run on the card: the
bf16 forward's (``csrc/layer_fused.cu``: ``nylon_gemm_bias[_drop]``,
``nylon_gemm_res_ln[_train]``), the bf16 backward's (``csrc/
layer_fused_train.cu``: ``nylon_gemm_nt``, the dX product, and
``nylon_wgrad`` + ``nylon_reduce_rows``, the dW product) and the float32
forward's (``csrc/layer_fused_f32.cu``: ``nylon_gemm_bias[_drop]_f32``,
``nylon_gemm_res_ln[_train]_f32``, and the stem layer's QKV on the CUDA
cores, ``nylon_gemm_bias_ffma_f32``) and the float32 backward's (the same
file's ``nylon_gemm_nt_f32``, dX, and ``nylon_wgrad_f32``, dW).

Each variant is a directory holding ``layer_fused.cu``,
``layer_fused_train.cu``, ``layer_fused_f32.cu``, ``mha_f32.cu``,
``mha.cu`` and the headers they include (a ``csrc/`` of some tree: the
working tree's, a parent commit's unpacked with ``git archive`` under
``build/``, a patched copy). Every source of every variant builds at once,
one nvcc each, with ``kernels.NVCC_FLAGS``, into its own library under
``build/gemm_ab/`` (``NAME_fwd.so``, ``NAME_bwd.so``, ``NAME_f32.so``,
``NAME_attn32.so``, ``NAME_attn16.so``); they load side by side through
ctypes, and are:

* held against the plain twins at small and ragged shapes: the forward's
  (``ops.layer_fused.gemm_bias_plain`` / ``gemm_res_ln_plain``, dropout
  sites and ``pre_out`` included) and dX (``ops.layer_fused_train.
  gemm_nt_plain``, every epilogue) within 4 bf16 ulps; dW and its bias
  sums (``weight_grad_plain``) no further from a float64 truth than twice
  the plain f32 twin's own distance + 1e-6 max |truth|; two runs
  bit-identical;
* the float32 forward GEMMs (``F32_CHECKS``: small, ragged and paper
  shapes, every variant) held within 2e-5 of max(1, max |plain f32 twin|),
  two runs bit-identical, with the kernel's and the plain twin's distances
  from a float64 truth of the same operands printed, the weight as its
  TF32 pair (two pointers, each half ``[N, K]``); and the stem QKV GEMM
  (``QKV_CHECKS``: ragged, default and paper shapes) the same way, its
  weight ``[K, N]``; the float32 dX and dW (``F32_BWD_CHECKS``: every
  epilogue, ragged and paper shapes): dX within 2e-5 of max(1, max |plain
  f32 twin|), dW and its bias sums no further from a float64 truth than
  twice the plain f32 twin's own distance + 1e-6 max |truth|, reruns
  bit-identical; dX reads the weight as its dX pair (``[Kout, N]``
  halves);
* compared with the first variant bit for bit; with ``--same`` a bf16
  forward output that differs from the first variant's, or a bf16 forward
  GEMM, a TF32 forward GEMM, an f32 dX / dW GEMM, a bf16 attention kernel
  (``mha.cu``) or an f32 attention kernel (``mha_f32.cu``) whose SASS
  (``cuobjdump -sass``) differs, fails the run. The first
  variant is the one under test: its gates decide the exit code; the
  others' are reported;
* timed at the GEMM shapes of the paper batch-32 forward and of the paper
  batch-8 training step's backward (its 43 dX and 43 dW products), in the
  order A B ... B A (CUDA events; the best of the two), beside bf16
  ``torch.matmul`` of the same product and the bound; and the float32
  forward GEMMs at the paper and the default widths' batch-32 shapes
  beside f32 ``torch.matmul`` (IEEE f32: ``allow_tf32`` off), the bound
  (bytes, or the products as 3xTF32 at 494.7 / 3 TFLOP/s) and the FFMA
  bound (the products at 67 TFLOP/s), with the stem QKV GEMM at its paper
  and default shapes beside the same f32 ``torch.matmul`` and its bound
  (the products at 67 TFLOP/s); and the float32 dX and dW at every product
  of the paper and the default batch-8 step (``step_bwd_products``) beside
  f32 ``torch.matmul``, the bound (bytes, or the products as 3xTF32) and
  the FFMA bound. ``--f32-bwd`` times only those.

A variant's dW row chunks and tile follow ``wgrad_layout``.

With ``--q8`` the run is the int8 layer kernels' alone (``csrc/
layer_fused_q8.cu``: ``nylon_q8_gemm_bias[_f32]``, ``nylon_q8_gemm_res_ln
[_f32]``, ``nylon_q8_attention[_f32]``; each variant builds that file and
``layer_fused.cu``): the GEMMs are held at ``Q8_CHECKS`` (ragged, default
and paper shapes, bf16 and f32, ReLU, ``quant_out`` and the row codes of
the GEMM + bias's column segments) against the plain twins (``ops.
layer_fused_q8.gemm_q8_bias_plain`` bit for bit, its codes and scales
``gemm_q8_bias_codes_plain``'s; ``gemm_q8_res_ln_plain`` within 4 bf16 ulps
or 2e-5 of max(1, |plain|), its output codes and scales those of
``_quant_rows`` of its own output), two runs bit-identical, then timed A B
.. B A by ``graph_ms`` at the 43 products of the paper batch-32 int8
forward (``q8_products``, each in the variant the forward runs) beside the
bound and ``torch._int_mm``; the attention is timed A B .. B A at the four
attention shapes of that forward (``Q8_ATTENTION``) beside its bound. A
variant whose ``layer_fused_q8.cu`` predates the row codes of the GEMM +
bias and of the attention (its entry points take none: ``Q8_PRE_CODES``)
is called with its own entry points: its GEMMs write every column in T,
its attention its output in T.

With ``--hash-mask`` the run is K6's standalone mask kernel alone
(``csrc/hash_mask.cu``: ``nylon_hash_mask``; each variant builds that file
and ``layer_fused.cu``): held bit for bit against ``ops.attention.
hash_keep_mask_plain`` (the mask, and x * mask) at ``HASH_CHECKS``
(packed and unpacked rows, ragged ones, a flat tail under a vector, a
``row0``), bf16 and f32, reruns bit-identical; then timed A B .. B A by
``graph_ms`` at ``HASH_TIMES`` (the embedding-dropout launches of the paper
bf16 and the default f32 batch-8 fused steps, and the per-site models'
activation sites at the paper widths) beside the bytes bound, with each
step's launches summed. With ``--reduce-rows`` the run is the partial-sum
reduction alone (``layer_fused_train.cu``'s ``nylon_reduce_rows``): held
bit for bit against ``ops.layer_fused_train.reduce_rows_plain`` at
``REDUCE_CHECKS``, reruns bit-identical, then timed A B .. B A by
``graph_ms`` at every launch of the paper bf16 and the default f32 batch-8
steps (``reduce_step_segments``: a dW product's weight and bias partials,
a layer's dgamma and dbeta partials), beside the bytes bound and
``parts.sum(0)`` of each segment; a variant from before the segment table
(one segment a launch) launches once a segment.

Run from the root of a checkout on the card::

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    python -m nylon_amt_tpu_torch.tools.gemm_ab --same \\
        new=nylon_amt_tpu_torch/csrc old=build/parent/nylon_amt_tpu_torch/csrc
    python -m nylon_amt_tpu_torch.tools.gemm_ab --q8 \\
        new=nylon_amt_tpu_torch/csrc old=build/parent/nylon_amt_tpu_torch/csrc

It prints the card's name and power limit first. A variant that fails to
build or to launch is reported and left out of the timings.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ENTRIES = {"fwd": ("nylon_gemm_bias", "nylon_gemm_bias_drop",
                   "nylon_gemm_res_ln", "nylon_gemm_res_ln_train"),
           "bwd": ("nylon_gemm_nt", "nylon_wgrad", "nylon_reduce_rows",
                   "nylon_ln_bwd", "nylon_ln_bwd_f32"),
           "f32": ("nylon_gemm_bias_f32", "nylon_gemm_bias_drop_f32",
                   "nylon_gemm_res_ln_f32", "nylon_gemm_res_ln_train_f32",
                   "nylon_gemm_nt_f32", "nylon_wgrad_f32"),
           "attn32": ("nylon_attention_f32", "nylon_attention_probs_f32",
                      "nylon_attention_drop_f32", "nylon_attention_bwd_f32",
                      "nylon_attention_bwd_ffma_f32",
                      "nylon_attention_ffma_f32"),
           "attn16": ("nylon_attention", "nylon_attention_probs",
                      "nylon_attention_drop", "nylon_attention_bwd"),
           "q8": ("nylon_q8_gemm_bias", "nylon_q8_gemm_res_ln",
                  "nylon_q8_attention", "nylon_q8_gemm_bias_f32",
                  "nylon_q8_gemm_res_ln_f32", "nylon_q8_attention_f32",
                  "nylon_q8_quant_cols", "nylon_q8_quant_cols_f32"),
           "hash": ("nylon_hash_mask",)}
SOURCES = {"fwd": "layer_fused.cu", "bwd": "layer_fused_train.cu",
           "f32": "layer_fused_f32.cu", "attn32": "mha_f32.cu",
           "attn16": "mha.cu", "q8": "layer_fused_q8.cu",
           "hash": "hash_mask.cu"}
# what --q8, --attn16 and --attn32 build (layer_fused.cu for the error
# strings)
Q8_PARTS = ("fwd", "q8")
ATTN16_PARTS = ("fwd", "attn16")
ATTN32_PARTS = ("fwd", "attn32")
# what --ln-bwd and --reduce-rows build (the LayerNorm backward and the
# reduction live in layer_fused_train.cu), and --hash-mask
LN_PARTS = ("fwd", "bwd")
HASH_PARTS = ("fwd", "hash")
# nylon_reduce_rows of a tree from before the segment table: parts, out, P,
# n, stream (one segment a launch)
REDUCE_PRE_SEGMENTS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p]
# entry points a variant may lack (a tree from before they were added): its
# kinds that need them are reported as absent, not failed
OPTIONAL_ENTRIES = ("nylon_attention_ffma_f32",)
# the stem QKV GEMM's entry point (a, w [K, N], bias, out, M, N, K, relu,
# stream)
QKV_ENTRY = "nylon_gemm_bias_ffma_f32"
# the kernels whose SASS --same holds, by library (not the f32 dX / dW,
# which the tensor-core kernels replaced)
SAME_KERNELS = {"fwd": ("gemm_bias_kernel", "gemm_res_ln_kernel"),
                "f32": ("gemm_bias_f32_kernel", "gemm_res_ln_f32_kernel"),
                "attn32": ("attn_fwd_f32_kernel", "attn_bwd_f32_kernel"),
                "attn16": ("attn_fwd_kernel", "attn_bwd_kernel")}
ULPS = 4
F32_REL = 2e-5  # f32 GEMMs: of max(1, max |plain f32 twin|)

# (kernel, M, K, N, ReLU, dropout, pre_out, out): one tile, ragged K, M and
# N, several tiles a block at every tile width, the training variants
CHECKS = [
    ("bias", 128, 64, 64, 0, 0, 0, 1), ("bias", 200, 96, 288, 0, 0, 0, 1),
    ("bias", 777, 160, 160, 1, 0, 0, 1), ("bias", 333, 32, 8, 1, 0, 0, 1),
    ("bias", 5000, 256, 512, 1, 1, 0, 1), ("bias", 300000, 64, 192, 0, 0, 0, 1),
    ("bias", 300000, 64, 64, 1, 0, 0, 1), ("bias", 300001, 96, 288, 0, 0, 0, 1),
    ("bias", 300000, 256, 768, 0, 0, 0, 1), ("bias", 300000, 64, 128, 0, 1, 0, 1),
    ("ln", 128, 64, 64, 0, 0, 0, 1), ("ln", 333, 32, 8, 0, 0, 0, 1),
    ("ln", 777, 160, 96, 0, 0, 0, 1), ("ln", 300000, 512, 256, 0, 0, 0, 1),
    ("ln", 300001, 160, 96, 0, 0, 0, 1), ("ln", 300000, 64, 64, 0, 0, 0, 1),
    ("ln", 5000, 256, 256, 0, 1, 0, 1), ("ln", 5000, 256, 256, 0, 1, 1, 1),
    ("ln", 5000, 512, 256, 0, 1, 1, 0), ("ln", 777, 96, 96, 0, 0, 1, 1),
]
# dX (M, N, Kout, side input, m1, m2) and dW (M, Ka, N): one tile, ragged
# M, K and N, every tile width, every epilogue the backward runs
BWD_CHECKS = [
    ("nt", 128, 64, 64, None, 0, 0), ("nt", 333, 96, 288, "addend", 0, 0),
    ("nt", 777, 160, 160, "gate", 1, 0), ("nt", 300001, 256, 512, "gate", 1, 0),
    ("nt", 300000, 768, 256, "addend", 0, 1), ("nt", 5000, 512, 256, None, 0, 0),
    ("nt", 300000, 192, 64, "addend", 0, 0), ("nt", 200, 8, 8, None, 0, 1),
    ("wg", 100, 64, 64), ("wg", 333, 96, 288), ("wg", 300001, 512, 256),
    ("wg", 300000, 256, 768), ("wg", 5000, 8, 8), ("wg", 90112, 160, 96),
]
# (label, M, K, N, ReLU, launches per batch-32 forward) of the paper model
PAPER = [
    ("bias qkv freq", 1048576, 256, 768, 0, 3),
    ("bias ffn1 freq", 1048576, 256, 512, 1, 3),
    ("bias kv cross", 1048576, 256, 512, 0, 3),
    ("bias q cross", 360448, 256, 256, 0, 3),
    ("bias qkv note/time", 360448, 256, 768, 0, 5),
    ("bias ffn1 note/time", 360448, 256, 512, 1, 6),
    ("ln o freq", 1048576, 256, 256, 0, 3),
    ("ln ffn2 freq", 1048576, 512, 256, 0, 3),
    ("ln o note/time", 360448, 256, 256, 0, 8),
    ("ln ffn2 note/time", 360448, 512, 256, 0, 6),
]
# the float32 forward GEMMs: (kernel, M, K, N, ReLU, dropout, pre_out,
# out), small and ragged shapes of every tile width and variant, and one
# paper shape of each product
F32_CHECKS = [
    ("bias", 128, 64, 64, 0, 0, 0, 1), ("bias", 200, 96, 288, 0, 0, 0, 1),
    ("bias", 777, 160, 160, 1, 0, 0, 1), ("bias", 333, 36, 8, 1, 0, 0, 1),
    ("bias", 5000, 256, 512, 1, 1, 0, 1), ("bias", 300001, 64, 192, 0, 0, 0, 1),
    ("bias", 300000, 256, 768, 0, 0, 0, 1), ("bias", 90001, 96, 288, 0, 1, 0, 1),
    ("ln", 128, 64, 64, 0, 0, 0, 1), ("ln", 333, 36, 8, 0, 0, 0, 1),
    ("ln", 777, 160, 96, 0, 0, 0, 1), ("ln", 300000, 512, 256, 0, 0, 0, 1),
    ("ln", 300001, 256, 256, 0, 0, 0, 1), ("ln", 300001, 128, 64, 0, 0, 0, 1),
    ("ln", 5000, 256, 256, 0, 1, 1, 1), ("ln", 5000, 512, 256, 0, 1, 1, 0),
    ("ln", 777, 96, 96, 0, 0, 1, 1), ("ln", 90001, 160, 96, 0, 1, 1, 1),
]
# the stem layer's QKV GEMM: (M, K, N), ragged, default and paper widths
QKV_CHECKS = [(333, 64, 192), (300001, 96, 288), (1048576, 64, 192),
              (1048576, 256, 768)]
# the float32 dX (M, N, Kout, side input, m1, m2) and dW (M, Ka, N): one
# tile, ragged M, K and N, every tile width, every epilogue the backward
# runs, and a paper shape of each
F32_BWD_CHECKS = BWD_CHECKS + [
    ("nt", 333, 36, 96, "gate", 1, 0), ("nt", 90001, 160, 96, "addend", 0, 1),
    ("wg", 333, 36, 96), ("wg", 90001, 96, 160), ("wg", 262144, 64, 192),
]
# (label, M, K, N, ReLU, launches per batch-32 forward) of the default
# widths (hid 64, pf 128, 2 + 2 + 2 layers)
DEFAULT = [
    ("bias qkv freq", 1048576, 64, 192, 0, 2),
    ("bias ffn1 freq", 1048576, 64, 128, 1, 2),
    ("bias kv cross", 1048576, 64, 128, 0, 2),
    ("bias q cross", 360448, 64, 64, 0, 2),
    ("bias qkv note/time", 360448, 64, 192, 0, 3),
    ("bias ffn1 note/time", 360448, 64, 128, 1, 4),
    ("ln o freq", 1048576, 64, 64, 0, 2),
    ("ln ffn2 freq", 1048576, 128, 64, 0, 2),
    ("ln o note/time", 360448, 64, 64, 0, 5),
    ("ln ffn2 note/time", 360448, 128, 64, 0, 4),
]
# the int8 GEMMs (kernel, M, K, N, ReLU, variant, dtype): one tile, ragged
# K, M and N, every tile width, a paper shape of each variant, and K up to
# 1024. The variant: the LayerNorm GEMM's quant_out; the GEMM + bias's row
# codes (segment width, segments, whether the other columns leave in T),
# or None
Q8_CHECKS = [
    (kern, m, k, n, relu, var, dt)
    for dt in ("bf16", "f32")
    for kern, m, k, n, relu, var in (
        ("bias", 128, 64, 64, 0, None), ("bias", 200, 96, 288, 0, None),
        ("bias", 777, 160, 160, 1, None), ("bias", 333, 32, 8, 1, None),
        ("bias", 300001, 64, 192, 0, None),
        ("bias", 300000, 256, 768, 0, None),
        ("bias", 90001, 256, 512, 1, None), ("ln", 128, 64, 64, 0, 1),
        ("ln", 333, 32, 8, 0, 1), ("ln", 777, 160, 96, 0, 1),
        ("ln", 300001, 256, 256, 0, 1), ("ln", 300000, 512, 256, 0, 0),
        ("ln", 90001, 128, 64, 0, 0), ("ln", 777, 96, 192, 0, 0),
        ("bias", 5000, 512, 512, 1, None), ("bias", 3001, 1024, 64, 0, None),
        ("ln", 3001, 1024, 192, 0, 1),
        # the row codes: QKV's Q and K, the cross KV's K, the cross Q, the
        # FFN hidden (a whole row over two tiles at pf 512)
        ("bias", 200, 96, 288, 0, (96, 2, 1)),
        ("bias", 300001, 64, 192, 0, (64, 2, 1)),
        ("bias", 300000, 256, 768, 0, (256, 2, 1)),
        ("bias", 5001, 256, 512, 0, (256, 1, 1)),
        ("bias", 777, 96, 192, 0, (96, 1, 1)),
        ("bias", 333, 256, 256, 0, (256, 1, 0)),
        ("bias", 90001, 256, 512, 1, (512, 1, 0)),
        ("bias", 777, 96, 160, 1, (160, 1, 0)),
        ("bias", 3001, 64, 128, 1, (128, 1, 0)))]
# the attention shapes of the paper batch-32 int8 forward (label, n, Lq,
# Lk, launches) at hid 256 over 4 heads
Q8_ATTENTION = [("freq self", 32 * 128, 256, 256, 3),
                ("time self", 32 * 88, 128, 128, 3),
                ("decoder self", 32 * 128, 88, 88, 2),
                ("cross", 32 * 128, 88, 256, 3)]
# the int8 entry points of a layer_fused_q8.cu that predates the row codes
# of the GEMM + bias and of the attention (the arguments without q, s, seg,
# n_seg, and without codes, scales: the attention writes o in T)
_P8, _I8, _L8, _F8 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
Q8_PRE_CODES = {
    "nylon_q8_gemm_bias": [_P8] * 6 + [_I8] * 4 + [_P8],
    "nylon_q8_attention": [_P8, _L8, _P8, _P8, _L8, _P8, _P8, _I8, _P8, _P8]
    + [_I8] * 5 + [_F8, _P8]}
# the per-site attention of chip_smoke.py (l): (label, Lq, Lk, sequences a
# window) at 4 heads of 64 (hid 256), batch 32 and 8; the checks at 16
# sequences of each, at 4 heads of 64 and 2 heads of 32, under (l)'s
# limits: outputs within ULPS bf16 ulps of the plain twin, input grads
# within ATTN_CHAIN_ULPS, K11's probabilities within ATTN_PROBS_ATOL
ATTN16_SITES = [("freq self", 256, 256, 128), ("cross", 88, 256, 128),
                ("note self", 88, 88, 128), ("time self", 128, 128, 88)]
ATTN16_BATCHES = (32, 8)
# (Lq, Lk) beside the sites, checked at 4 sequences: one key (every grad
# of q and k exactly 0), tiers' edges, Lq past 128, a few keys
ATTN16_ODD = [(1, 1), (7, 13), (57, 200), (65, 97), (129, 40), (256, 8)]
ATTN16_KINDS = ("fwd", "probs", "drop", "bwd", "drop_bwd")
ATTN_CHAIN_ULPS, ATTN_PROBS_ATOL = 12, 1e-5
ATTN_SCALE = 0.125
# the f32 attention (mha_f32.cu) under chip_smoke.py (n.1)'s gates: outputs
# within ATTN32_OUT_REL of max(1, max |plain f32|), input grads within
# ATTN32_GRAD_REL of max |plain f32|, K11's probabilities within
# ATTN32_PROBS_ATOL and its rows summing to 1 within ATTN32_ROW_ATOL; every
# kind at 16 sequences of each ATTN16_SITES at hid 256 over 4 heads, 64 over
# 2 and 96 over 3 (the self sites on packed QKV views), and at 4 sequences
# of each ATTN16_ODD; timed at the sites at D 32 (hid 64 over 2 heads) and D
# 64 (256 over 4), the forwards at batch 32, the backwards at batch 8
ATTN32_OUT_REL, ATTN32_GRAD_REL = 2e-5, 1e-4
ATTN32_PROBS_ATOL, ATTN32_ROW_ATOL = 1e-6, 1e-5
# fwd, K11, K12, the backward and K12's; the stem-fed layer's FFMA-score
# forward (nylon_attention_ffma_f32, OPTIONAL_ENTRIES) and backward
ATTN32_KINDS = ("fwd", "probs", "drop", "bwd", "drop_bwd", "ffma_fwd",
                "ffma_bwd")
ATTN_KINDS = {"attn16": ATTN16_KINDS, "attn32": ATTN32_KINDS}
ATTN32_WIDTHS = ((64, 2), (256, 4))
HBM_BPS, BF16_FLOPS = 3.35e12, 989e12  # H100 SXM, published
TF32_FLOPS, F32_FLOPS = 494.7e12, 67e12
INT8_OPS = 1979e12
DROP_SEED, RATE = 77, 0.1


def step_bwd_products(mf, mq, hid, pf, n_enc, n_dec, n_time) -> list:
    """Every dX product (label, "gemm_nt", M, N, Kout, side input, m1, m2,
    launches) and dW product (label, "wgrad", M, Ka, N, launches) of one
    training step's backward at these widths (frequency-stream rows mf,
    note/time-stream rows mq): K7 on n_enc frequency and n_time time layers
    (the first of each with the embedding site m2), K8 once, K9 n_dec - 1
    times (its cross tail and its self prologue)."""
    nt_, cross = n_time + n_dec, n_dec
    dx = [("ffn2 freq", mf, hid, pf, "gate", 1, 0, n_enc),
          ("ffn1 freq", mf, pf, hid, "addend", 0, 0, n_enc),
          ("o freq", mf, hid, hid, None, 0, 0, n_enc),
          ("qkv freq", mf, 3 * hid, hid, "addend", 0, 0, n_enc - 1),
          ("qkv freq, emb", mf, 3 * hid, hid, "addend", 0, 1, 1),
          ("kv cross", mf, 2 * hid, hid, None, 0, 0, cross),
          ("ffn2 note/time", mq, hid, pf, "gate", 1, 0, nt_),
          ("ffn1 note/time", mq, pf, hid, "addend", 0, 0, nt_),
          ("o note/time", mq, hid, hid, None, 0, 0, nt_ + n_dec - 1),
          ("q cross", mq, hid, hid, "addend", 0, 0, cross),
          ("qkv note/time", mq, 3 * hid, hid, "addend", 0, 0,
           n_time - 1 + n_dec - 1),
          ("qkv time, emb", mq, 3 * hid, hid, "addend", 0, 1, 1)]
    dw = [("ffn2 freq", mf, pf, hid, n_enc), ("ffn1 freq", mf, hid, pf, n_enc),
          ("o freq", mf, hid, hid, n_enc), ("qkv freq", mf, hid, 3 * hid, n_enc),
          ("kv cross", mf, hid, 2 * hid, cross),
          ("ffn2 note/time", mq, pf, hid, nt_),
          ("ffn1 note/time", mq, hid, pf, nt_),
          ("o, q cross note/time", mq, hid, hid, nt_ + 2 * n_dec - 1),
          ("qkv note/time", mq, hid, 3 * hid, nt_ - 1)]
    return ([(label, "gemm_nt", *rest) for label, *rest in dx]
            + [(label, "wgrad", *rest) for label, *rest in dw])


# the paper batch-8 step: 8 windows x 128 frames x 256 bins / 88 notes
PAPER_STEP = step_bwd_products(8 * 128 * 256, 8 * 128 * 88, 256, 512, 3, 3,
                               3)
# the default Config()'s batch-8 step (hid 64, pf 128, 2 + 2 + 2 layers)
DEFAULT_STEP = step_bwd_products(8 * 128 * 256, 8 * 128 * 88, 64, 128, 2, 2,
                                 2)


def ln_step_shapes(m, batch: int = 8) -> list:
    """(M, launches) of the LayerNorm backward of a batch-``batch`` fused
    training step of model config ``m``: two launches an encoder-type
    layer (frequency and time), two for decoder_layer_zero, three a
    decoder layer; a frequency layer's rows are frames x bins, every other
    layer's frames x notes."""
    from nylon_amt_tpu_torch.config import Config

    c = Config()
    frames = batch * c.input.num_frame
    return [(frames * c.feature.n_bins, 2 * m.enc_layer),
            (frames * c.midi.num_note,
             2 * m.dec_layer + 2 + 3 * (m.dec_layer - 1))]


def reduce_step_segments(m, dtype, sms: int, batch: int = 8) -> list:
    """Every launch of the partial-sum reduction in a batch-``batch`` fused
    training step of model config ``m`` in ``dtype`` on a card of ``sms``
    SMs, as (label, [(P, n) of each segment], launches): a dW product's
    weight partials ``[chunks, Ka * N]`` and bias partials ``[chunks *
    ceil(Ka / tile rows), N]`` (``wgrad_layout``), and a layer's dgamma and
    dbeta partials ``[slots * blocks, hid]`` (``ln_bwd_plan``; two slots an
    encoder-type layer and decoder_layer_zero, three a decoder layer)."""
    from nylon_amt_tpu_torch.config import Config
    from nylon_amt_tpu_torch.ops.layer_fused_train import (ln_bwd_plan,
                                                           wgrad_layout)

    c = Config()
    frames = batch * c.input.num_frame
    mf, mq = frames * c.feature.n_bins, frames * c.midi.num_note
    hid = m.hid_dim
    out = []
    for label, _, rows, ka, n, count in (
            p for p in step_bwd_products(mf, mq, hid, m.pf_dim, m.enc_layer,
                                         m.dec_layer, m.dec_layer)
            if p[1] == "wgrad"):
        bm, _, _, chunks = wgrad_layout(rows, ka, n, dtype, sms)
        out.append((f"dW {label}", [(chunks, ka * n),
                                    (chunks * -(-ka // bm), n)], count))
    for label, rows, slots, count in (
            ("LN freq", mf, 2, m.enc_layer), ("LN time", mq, 2, m.dec_layer),
            ("LN dec zero", mq, 2, 1), ("LN dec", mq, 3, m.dec_layer - 1)):
        p = slots * ln_bwd_plan(rows, hid, dtype, sms)[1]
        out.append((label, [(p, hid), (p, hid)], count))
    return [seg for seg in out if seg[2]]


# (M, N, dtype, dropout site) the LayerNorm backward is held at: ragged
# row counts, every lane layout (1, 2, 3 chunks a lane, idle lanes at
# N 160), a few tiles or thousands of them
LN_CHECKS = [(1003, 256, "bf16", True), (1003, 256, "bf16", False),
             (4099, 96, "bf16", True), (777, 64, "bf16", False),
             (2049, 160, "bf16", True), (90112, 256, "bf16", True),
             (1003, 256, "f32", True), (4099, 96, "f32", False),
             (777, 64, "f32", True), (2049, 224, "f32", True),
             (90112, 64, "f32", True)]
# (hid, V's packed width: 3 a self-attention's QKV, 2 a cross KV, n, Lk) V's
# quantizer is held at (bit for bit)
Q8_COLS_CHECKS = [(256, 3, 64, 256), (256, 2, 64, 88), (64, 3, 128, 128),
                  (96, 2, 100, 88), (96, 3, 33, 40)]


def q8_products(mf, mq, hid, pf, n_enc, n_dec, n_time) -> list:
    """Every (label, kernel, M, K, N, relu, variant, launches) of an int8
    forward of these widths (frequency-stream rows mf, note/time-stream
    rows mq): n_enc frequency encoder layers, the decoder's layer zero and
    n_dec - 1 self + cross layers, n_time time layers, each product in the
    variant the forward runs. The GEMM + bias's variant: the row codes of
    its first column segments (segment width, segments, whether the other
    columns leave in T): Q and K of the QKV product, K of the cross KV
    product, the cross Q and the FFN hidden (codes only). The LayerNorm
    GEMM's: whether it also quantizes its output (quant_out): always the
    attention output's projection (the FFN's input), and the FFN's second
    product where a next layer takes the layer's output as codes (every
    one but the last decoder and the last time layer)."""
    bias, ln = "gemm_q8_bias", "gemm_q8_res_ln"
    qkv, kv, whole = (hid, 2, 1), (hid, 1, 1), (hid, 1, 0)
    last = (n_dec > 0) + (n_time > 0)  # the streams' last layers
    return [
        ("qkv freq", bias, mf, hid, 3 * hid, 0, qkv, n_enc),
        ("ffn1 freq", bias, mf, hid, pf, 1, (pf, 1, 0), n_enc),
        ("kv cross", bias, mf, hid, 2 * hid, 0, kv, n_dec),
        ("q cross", bias, mq, hid, hid, 0, whole, n_dec),
        ("qkv note/time", bias, mq, hid, 3 * hid, 0, qkv, n_dec - 1 + n_time),
        ("ffn1 note/time", bias, mq, hid, pf, 1, (pf, 1, 0), n_dec + n_time),
        ("o freq", ln, mf, hid, hid, 0, 1, n_enc),
        ("ffn2 freq", ln, mf, pf, hid, 0, 1, n_enc),
        ("o note/time", ln, mq, hid, hid, 0, 1, 2 * n_dec - 1 + n_time),
        ("ffn2 note/time", ln, mq, pf, hid, 0, 1, n_dec + n_time - last),
        ("ffn2 last", ln, mq, pf, hid, 0, 0, last)]


# the paper batch-32 int8 forward's 43 products
PAPER_Q8 = q8_products(32 * 128 * 256, 32 * 128 * 88, 256, 512, 3, 3, 3)


def build(variants: dict, out_dir: Path, parts=tuple(SOURCES)) -> dict:
    """``{name: {part: path} or None}``: every variant's sources of
    ``parts``, each in its own nvcc, all started together."""
    from nylon_amt_tpu_torch import kernels

    nvcc = kernels.find_nvcc()
    if nvcc is None:
        raise SystemExit("gemm_ab: no nvcc")
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in variants.items():
        for part in parts:
            file = SOURCES[part]
            lib = out_dir / f"{name}_{part}.so"
            cmd = [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", str(lib),
                   str(Path(src) / file)]
            procs[name, part] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for (name, part), (lib, proc) in procs.items():
        log = proc.communicate()[0]
        (out_dir / f"{name}_{part}.log").write_text(log)
        if proc.returncode:
            print(f"{name}: {SOURCES[part]} build failed (exit "
                  f"{proc.returncode}); {out_dir / name}_{part}.log:\n"
                  f"{log[-3000:]}", flush=True)
        libs.setdefault(name, {})[part] = None if proc.returncode else lib
    return {name: paths if all(paths.values()) else None
            for name, paths in libs.items()}


class Refused(Exception):
    """An entry point refused its arguments (a shape it does not take)."""


class Lib:
    """One variant's libraries: the GEMM entry points on tensors."""

    def __init__(self, paths: dict, src: Path):
        from nylon_amt_tpu_torch import kernels

        # whether the int8 entry points take the row codes (Q8_PRE_CODES)
        self.q8_codes = "q8" in paths and "int seg, int n_seg" in (
            Path(src) / SOURCES["q8"]).read_text()
        # whether the LayerNorm backward takes a tile plan (ln_layout) or
        # its first form's rows a block
        self.ln_tiles = "bwd" in paths and "ln_layout" in (
            Path(src) / SOURCES["bwd"]).read_text()
        # whether the reduction takes a table of segments (one launch a
        # call site) or one segment a launch
        self.reduce_segs = "bwd" in paths and "RedTable" in (
            Path(src) / SOURCES["bwd"]).read_text()
        self.libs = {}
        for part, path in paths.items():
            lib = ctypes.CDLL(str(path))
            for e in ENTRIES[part] + ((QKV_ENTRY,) if part == "f32" else ()):
                if e in OPTIONAL_ENTRIES and not hasattr(lib, e):
                    continue
                base = e.removesuffix("_f32")
                getattr(lib, e).argtypes = (
                    Q8_PRE_CODES[base] if part == "q8" and not self.q8_codes
                    and base in Q8_PRE_CODES else REDUCE_PRE_SEGMENTS
                    if e == "nylon_reduce_rows" and not self.reduce_segs
                    else kernels._SIGNATURES[e])
                getattr(lib, e).restype = ctypes.c_int
            self.libs[part] = lib
        # layer_fused.cu defines the message lookup
        self.error_string = self.libs["fwd"].nylon_error_string
        self.error_string.argtypes = [ctypes.c_int]
        self.error_string.restype = ctypes.c_char_p

    def _call(self, part, name, *args):
        status = getattr(self.libs[part], name)(*args)
        if status == 1:  # cudaErrorInvalidValue: arguments it does not take
            raise Refused(name)
        if status:
            msg = self.error_string(status).decode()
            raise RuntimeError(f"{name}: CUDA error {status} ({msg})")

    def _fwd(self, a, w, pair):
        """(library part, entry suffix, the weight's pointers as this
        variant reads it)."""
        import torch

        from nylon_amt_tpu_torch.ops.layer_fused import tf32_pair

        if a.dtype != torch.float32:
            return "fwd", "", (w.data_ptr(),)
        halves = tf32_pair(w) if pair is None else pair
        return "f32", "_f32", tuple(h.data_ptr() for h in halves)

    def bias(self, a, w, b, relu=0, site=None, pair=None):
        import torch

        (m, k), n = a.shape, w.shape[1]
        part, sfx, wk = self._fwd(a, w, pair)
        out = torch.empty((m, n), dtype=a.dtype, device=a.device)
        s = torch.cuda.current_stream().cuda_stream
        args = (a.data_ptr(), *wk, b.data_ptr(), out.data_ptr(), m, n, k,
                relu)
        if site is None:
            self._call(part, "nylon_gemm_bias" + sfx, *args, s)
        else:
            self._call(part, "nylon_gemm_bias_drop" + sfx, *args, *site, s)
        return [out]

    def qkv(self, a, w, b):
        """The stem layer's QKV GEMM: f32 ``a @ w + b``, w ``[K, N]``."""
        import torch

        (m, k), n = a.shape, w.shape[1]
        out = torch.empty((m, n), dtype=a.dtype, device=a.device)
        self._call("f32", QKV_ENTRY, a.data_ptr(), w.data_ptr(),
                   b.data_ptr(), out.data_ptr(), m, n, k, 0,
                   torch.cuda.current_stream().cuda_stream)
        return [out]

    def res_ln(self, a, w, b, res, g, be, site=None, pre=0, out=1,
               pair=None):
        import torch

        from nylon_amt_tpu_torch.ops.layer_fused_train import _NO_SITE

        (m, k), n = a.shape, w.shape[1]
        part, sfx, wk = self._fwd(a, w, pair)
        s = torch.cuda.current_stream().cuda_stream
        y = torch.empty((m, n), dtype=a.dtype, device=a.device) if out \
            else None
        p = torch.empty((m, n), dtype=a.dtype, device=a.device) if pre \
            else None
        ptrs = (a.data_ptr(), *wk, b.data_ptr(), res.data_ptr(),
                g.data_ptr(), be.data_ptr())
        if site is None and not pre:
            self._call(part, "nylon_gemm_res_ln" + sfx, *ptrs, y.data_ptr(),
                       m, n, k, 1e-5, s)
        else:
            self._call(part, "nylon_gemm_res_ln_train" + sfx, *ptrs,
                       None if y is None else y.data_ptr(),
                       None if p is None else p.data_ptr(), m, n, k, 1e-5,
                       int(site is not None), *(site or _NO_SITE), s)
        return [t for t in (y, p) if t is not None]

    def nt(self, dy, w, gate=None, addend=None, m1=None, m2=None,
           pair=None):
        import torch

        from nylon_amt_tpu_torch.ops.layer_fused import tf32_pair
        from nylon_amt_tpu_torch.ops.layer_fused_train import _NO_SITE

        m, n = dy.shape
        kout = w.shape[0]
        out = torch.empty((m, kout), dtype=dy.dtype, device=dy.device)
        part, name, wk = "bwd", "nylon_gemm_nt", (w.data_ptr(),)
        if dy.dtype == torch.float32:
            part, name = "f32", "nylon_gemm_nt_f32"
            halves = tf32_pair(w, nt=True) if pair is None else pair
            wk = tuple(h.data_ptr() for h in halves)
        self._call(part, name, dy.data_ptr(), *wk,
                   out.data_ptr(), None if gate is None else gate.data_ptr(),
                   None if addend is None else addend.data_ptr(), m, n, kout,
                   int(m1 is not None), *(m1 or _NO_SITE),
                   int(m2 is not None), *(m2 or _NO_SITE),
                   torch.cuda.current_stream().cuda_stream)
        return out

    def wgrad(self, a, dy):
        """(a^T dy, column sums of dy): the kernel over this variant's row
        chunks, then the fixed-order reduction of the partials."""
        import torch

        from nylon_amt_tpu_torch.ops.layer_fused_train import wgrad_layout

        (m, ka), n = a.shape, dy.shape[1]
        sms = torch.cuda.get_device_properties(a.device).multi_processor_count
        f32_ = a.dtype == torch.float32
        lib, name = ("f32", "nylon_wgrad_f32") if f32_ else (
            "bwd", "nylon_wgrad")
        bm, bn, rows, chunks = wgrad_layout(m, ka, n, a.dtype, sms)
        tile = (bm, bn) if f32_ else ()
        s = torch.cuda.current_stream().cuda_stream
        f32 = dict(dtype=torch.float32, device=a.device)
        part, bias_part = torch.empty((chunks, ka, n), **f32), \
            torch.empty((chunks * -(-ka // bm), n), **f32)
        self._call(lib, name, a.data_ptr(), dy.data_ptr(),
                   part.data_ptr(), bias_part.data_ptr(), m, ka, n, rows,
                   chunks, *tile, s)
        dw, db = self.reduce([part.view(chunks, -1), bias_part])
        return [dw.view(ka, n), db]

    def reduce(self, parts_list):
        """The rows of each ``parts [P, *]`` (f32) summed in row order: one
        launch for all, or (a variant without the segment table) one a
        segment."""
        import torch

        from nylon_amt_tpu_torch.ops.layer_fused_train import \
            reduce_rows_plan

        outs = [torch.empty(p.shape[1:], dtype=torch.float32,
                            device=p.device) for p in parts_list]
        s = torch.cuda.current_stream().cuda_stream
        if not self.reduce_segs:
            for p, out in zip(parts_list, outs):
                self._call("bwd", "nylon_reduce_rows", p.data_ptr(),
                           out.data_ptr(), p.shape[0], out.numel(), s)
            return outs
        segs = []
        for p, out in zip(parts_list, outs):
            segs += [p.data_ptr(), out.data_ptr(), p.shape[0], out.numel(),
                     reduce_rows_plan(p.shape[0], out.numel())[0]]
        segs += [None, None, 0, 0, 0] * (2 - len(parts_list))
        self._call("bwd", "nylon_reduce_rows", *segs, s)
        return outs

    def hash_mask(self, x, rows, d2, dtype, seed, tag, row0, rate):
        """K6's kernel over a ``(rows, d2)`` view of ``dtype`` (``row0``:
        the JAX function's, with d1 = rows): the mask, or x * mask."""
        import torch

        from nylon_amt_tpu_torch.ops import attention as att

        th, keep, half = att.site_constants(rate, d2, dtype)
        base = (row0 * rows * (half or d2)) & 0xFFFFFFFF
        out = torch.empty((rows, d2), dtype=dtype, device="cuda")
        self._call("hash", "nylon_hash_mask",
                   None if x is None else x.data_ptr(), out.data_ptr(),
                   rows, d2, att.site_key(seed, tag), th, keep, half, base,
                   int(dtype == torch.bfloat16),
                   torch.cuda.current_stream().cuda_stream)
        return out

    def q8(self, x, relu=0, var=None):
        """An int8 GEMM of ``q8_inputs`` ``x``: the GEMM + bias, ``[out]``,
        or with its row codes ``var`` (segment width, segments, T out)
        ``[out or None, codes, scales]``; or with ``x["res"]`` ``[out]`` of
        the residual + LayerNorm one [+ its output codes and scales, with
        ``var``: quant_out]. A variant without the row codes (Q8_PRE_CODES)
        writes every column of the GEMM + bias in T: ``[out]``."""
        import torch

        (m, k), n = x["aq"].shape, x["wq"].shape[1]
        dt, dev = x["bias"].dtype, x["aq"].device
        sfx = "" if dt == torch.bfloat16 else "_f32"
        s = torch.cuda.current_stream().cuda_stream
        head = (x["aq"].data_ptr(), x["sa"].data_ptr(), x["wt"].data_ptr(),
                x["sw"].data_ptr(), x["bias"].data_ptr())
        if "res" not in x:
            if not self.q8_codes:
                out = torch.empty((m, n), dtype=dt, device=dev)
                self._call("q8", "nylon_q8_gemm_bias" + sfx, *head,
                           out.data_ptr(), m, n, k, relu, s)
                return [out]
            seg, n_seg, t_out = var or (0, 0, 1)
            out = torch.empty((m, n), dtype=dt, device=dev) \
                if t_out else None
            q = torch.empty((m, seg * n_seg), dtype=torch.int8, device=dev) \
                if n_seg else None
            sc = torch.empty((n_seg, m), dtype=torch.float32, device=dev) \
                if n_seg else None
            self._call("q8", "nylon_q8_gemm_bias" + sfx, *head,
                       None if out is None else out.data_ptr(),
                       None if q is None else q.data_ptr(),
                       None if sc is None else sc.data_ptr(), m, n, k, relu,
                       seg, n_seg, s)
            return [out, q, sc] if n_seg else [out]
        q = torch.empty((m, n), dtype=torch.int8, device=dev) \
            if var else None
        sc = torch.empty((m,), dtype=torch.float32, device=dev) \
            if var else None
        out = torch.empty((m, n), dtype=dt, device=dev)
        self._call("q8", "nylon_q8_gemm_res_ln" + sfx, *head,
                   x["res"].data_ptr(), x["g"].data_ptr(),
                   x["be"].data_ptr(), out.data_ptr(),
                   None if q is None else q.data_ptr(),
                   None if sc is None else sc.data_ptr(), m, n, k, 1e-5, s)
        return [t for t in (out, q, sc) if t is not None]

    def attention_q8(self, a, t_out=False):
        """The int8 attention of ``q8_attention_inputs`` ``a``: ``[codes,
        scales]`` (with ``t_out`` also the output in T, first); a variant
        without the row codes (Q8_PRE_CODES) writes its output in T only:
        ``[out]``."""
        import torch

        n, lq, hid, heads = a["n"], a["lq"], a["hid"], a["heads"]
        dt, dev = a["dt"], a["qq"].device
        sfx = "" if dt == torch.bfloat16 else "_f32"
        s = torch.cuda.current_stream().cuda_stream
        args = (a["qq"].data_ptr(), a["qq"].stride(0), a["sq"].data_ptr(),
                a["kq"].data_ptr(), a["kq"].stride(0), a["sk"].data_ptr(),
                a["vt"].data_ptr(), a["vt"].shape[2], a["sv"].data_ptr())
        tail = (n, lq, a["lk"], heads, hid // heads, a["scale_log2e"], s)
        out = torch.empty((n * lq, hid), dtype=dt, device=dev) \
            if t_out or not self.q8_codes else None
        if not self.q8_codes:
            self._call("q8", "nylon_q8_attention" + sfx, *args,
                       out.data_ptr(), *tail)
            return [out]
        codes = torch.empty((n * lq, hid), dtype=torch.int8, device=dev)
        sc = torch.empty((n * lq,), dtype=torch.float32, device=dev)
        self._call("q8", "nylon_q8_attention" + sfx, *args, codes.data_ptr(),
                   sc.data_ptr(), None if out is None else out.data_ptr(),
                   *tail)
        return ([out] if t_out else []) + [codes, sc]


    def ln_bwd(self, dy, s, g, site=None):
        """The LayerNorm backward of ``dy`` and the pre-LN sum ``s`` as this
        variant plans it: ``[da, dam (with a site), dgamma and dbeta
        partials [blocks, N]]``."""
        import torch

        from nylon_amt_tpu_torch.ops import layer_fused_train as tlt
        from nylon_amt_tpu_torch.ops.layer_fused import _LN_EPS

        m, n = dy.shape
        if self.ln_tiles:
            rows, blocks = tlt.ln_bwd_plan(
                m, n, dy.dtype, tlt._sm_count(dy.device.index))
        else:  # its first form: at most 264 blocks of 8 warps
            blocks = min(264, -(-m // 8))
            rows = -(-m // blocks)
        da = torch.empty_like(dy)
        dam = torch.empty_like(dy) if site is not None else da
        parts = torch.empty((2, blocks, n), dtype=torch.float32,
                            device=dy.device)
        self._call("bwd", "nylon_ln_bwd" + (
            "" if dy.dtype == torch.bfloat16 else "_f32"), dy.data_ptr(),
            s.data_ptr(), g.data_ptr(), da.data_ptr(), dam.data_ptr(),
            parts[0].data_ptr(), parts[1].data_ptr(), m, n, rows, blocks,
            _LN_EPS, int(site is not None), *(site or (0, 0, 0.0, 0)),
            torch.cuda.current_stream().cuda_stream)
        return [da] + ([dam] if site is not None else []) + [parts]

    def quant_cols(self, v, n):
        """V's quantizer on the strided view ``v [n Lk, hid]``: ``[vt,
        sv]``."""
        import torch

        rows, hid = v.shape
        lk = rows // n
        vt = torch.empty((n, hid, -(-lk // 32) * 32), dtype=torch.int8,
                         device=v.device)
        sv = torch.empty((n, hid), dtype=torch.float32, device=v.device)
        self._call("q8", "nylon_q8_quant_cols" + (
            "" if v.dtype == torch.bfloat16 else "_f32"), v.data_ptr(),
            v.stride(0), n, lk, hid, vt.data_ptr(), sv.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        return [vt, sv]

    def attention(self, part, q, k, v, heads, kind="fwd", do=None):
        """The attention of ``part`` ("attn16": bf16, mha.cu; "attn32": f32,
        mha_f32.cu) on ``[n, L, hid]`` q, k, v (row-strided views with a
        unit column stride, such as column slices of a packed QKV; scale
        ATTN_SCALE): ``kind`` "fwd" ``[out]``, "probs" ``[out, probs]``,
        "drop" ``[out]`` (rate RATE, seed DROP_SEED, heads' raw tags, as
        K12), "bwd" / "drop_bwd" ``[dq, dk, dv]`` (contiguous) given ``do``;
        f32 also "ffma_fwd" / "ffma_bwd" (the stem-fed layer's FFMA-score
        entry points, no dropout)."""
        import torch

        from nylon_amt_tpu_torch.ops.attention import seed_mix, site_constants
        from nylon_amt_tpu_torch.ops.layer_fused import _LOG2E

        sfx = "_f32" if part == "attn32" else ""
        n, lq, hid = q.shape
        lk, d = k.shape[1], hid // heads
        s = torch.cuda.current_stream().cuda_stream
        drop = kind.startswith("drop")
        site = (site_constants(RATE, lk, torch.float32) if drop
                else (0, 0.0, 0))
        if kind.endswith("bwd"):
            grads = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                     for t in (q, k, v)]
            entry = ("nylon_attention_bwd_ffma" if kind == "ffma_bwd"
                     else "nylon_attention_bwd") + sfx
            self._call(part, entry, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), do.data_ptr(),
                       *(g.data_ptr() for g in grads), n, lq, lk, heads, d,
                       q.stride(1), k.stride(1), do.stride(1), hid, hid,
                       ATTN_SCALE, ATTN_SCALE * _LOG2E, int(drop),
                       seed_mix(DROP_SEED), 0, *site, s)
            return grads
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        geo = (n, lq, lk, heads, d, q.stride(1), q.stride(0), k.stride(1),
               k.stride(0), ATTN_SCALE * _LOG2E)
        if kind == "probs":
            probs = torch.empty((n, heads, lq, lk), dtype=torch.float32,
                                device=q.device)
            self._call(part, "nylon_attention_probs" + sfx, *ptrs,
                       probs.data_ptr(), *geo, s)
            return [out, probs]
        if kind == "ffma_fwd":
            self._call(part, "nylon_attention_ffma_f32", *ptrs, *geo, 0, 0, 0,
                       0, 1.0, 0, s)
        elif drop:
            self._call(part, "nylon_attention_drop" + sfx, *ptrs, *geo,
                       seed_mix(DROP_SEED), 0, *site, s)
        else:
            self._call(part, "nylon_attention" + sfx, *ptrs, *geo, s)
        return [out]

    def attention_kinds(self, part) -> tuple:
        """The kinds of ``part`` (ATTN_KINDS) that this library has."""
        return tuple(k for k in ATTN_KINDS[part] if k != "ffma_fwd"
                     or hasattr(self.libs[part], "nylon_attention_ffma_f32"))


def q8_inputs(m, k, n, ln, dtype, seed=0):
    """An int8 GEMM's operands: the codes and scales of seeded activations
    and weights in ``dtype`` (the plain quantizers'), the codes K-major
    (``wt``), the bias in ``dtype``; with ``ln`` the residual in ``dtype``
    and the LayerNorm's f32 gamma and beta."""
    import torch

    from nylon_amt_tpu_torch.ops import layer_fused_q8 as lq

    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    aq, sa = lq._quant_rows(r(m, k).to(dtype))
    wq, sw = lq.quantize_weight((r(k, n) / math.sqrt(k)).to(dtype))
    x = dict(aq=aq, sa=sa.reshape(-1).contiguous(), wq=wq,
             wt=wq.t().contiguous(), sw=sw, bias=(0.1 * r(n)).to(dtype))
    if ln:
        x.update(res=r(m, n).to(dtype), g=1.0 + 0.1 * r(n), be=0.1 * r(n))
    return x


def q8_attention_inputs(n, lq, lk, hid, heads, dtype, seed=0):
    """An int8 attention's operands: the codes and row scales of seeded Q
    and K in ``dtype`` (the plain quantizer's), V's per-column codes
    transposed per sequence and padded to a multiple of 32 keys with zero
    codes, ``[n, hid, Lk_pad]`` (what ``quant_cols_cuda`` writes), and
    their scales; with the plain twin's own operands (``plain``)."""
    import torch

    from nylon_amt_tpu_torch.ops import layer_fused_q8 as lq_
    from nylon_amt_tpu_torch.ops.layer_fused import _LOG2E, _scale

    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    qq, sq = lq_._quant_rows(r(n, lq, hid))
    kq, sk = lq_._quant_rows(r(n, lk, hid))
    vq, sv = lq_._quant_cols(r(n, lk, hid))
    lk_pad = -(-lk // 32) * 32
    vt = torch.zeros((n, hid, lk_pad), dtype=torch.int8, device="cuda")
    vt[:, :, :lk] = vq.transpose(1, 2)
    return dict(qq=qq.reshape(-1, hid), sq=sq.reshape(-1).contiguous(),
                kq=kq.reshape(-1, hid), sk=sk.reshape(-1).contiguous(),
                vt=vt, sv=sv.reshape(n, hid).contiguous(), n=n, lq=lq, lk=lk,
                hid=hid, heads=heads, dt=dtype,
                scale_log2e=_scale(hid, heads) * _LOG2E,
                plain=(qq, sq, kq, sk, vq, sv))


def inputs(m, k, n, seed=0, dtype=None):
    """A GEMM's operands in ``dtype`` (bf16 unless given); for float32 also
    the weight's TF32 pair (``pair``)."""
    import torch

    from nylon_amt_tpu_torch.ops.layer_fused import tf32_pair

    dt = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    x = dict(a=r(m, k).to(dt), w=(r(k, n) / math.sqrt(k)).to(dt),
             b=(0.1 * r(n)).to(dt), res=r(m, n).to(dt),
             g=1.0 + 0.1 * r(n), be=0.1 * r(n))
    if dt == torch.float32:
        x["pair"] = tf32_pair(x["w"])
    return x


def bwd_inputs(case, seed=0, dtype=None):
    """dX: dy [M, N], w [Kout, N], the side input [M, Kout] and the sites
    (float32: also w's dX pair, ``pair``); dW: a [M, Ka], dy [M, N]; in
    ``dtype`` (bf16 unless given)."""
    import torch

    from nylon_amt_tpu_torch.ops.layer_fused import tf32_pair
    from nylon_amt_tpu_torch.ops.layer_fused_train import (
        _SITE_EMB, _SITE_FFN_MID, _site)

    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    dt = dtype or torch.bfloat16
    if case[0] != "nt":
        _, m, ka, n = case
        return dict(a=r(m, ka).to(dt), dy=r(m, n).to(dt))
    _, m, n, kout, side, act1, act2 = case
    x = dict(dy=r(m, n).to(dt), w=(r(kout, n) / math.sqrt(n)).to(dt))
    if side:
        x[side] = r(m, kout).to(dt)
    if act1:
        x["m1"] = _site(DROP_SEED, _SITE_FFN_MID, kout, RATE, dt)
    if act2:
        x["m2"] = _site(DROP_SEED, _SITE_EMB, kout, RATE, dt)
    if dt == torch.float32:
        x["pair"] = tf32_pair(x["w"], nt=True)
    return x


def _run(lib: Lib, case, x, site):
    kind, relu, pre, out = case[0], case[4], case[6], case[7]
    if kind == "bias":
        return lib.bias(x["a"], x["w"], x["b"], relu, site, x.get("pair"))
    return lib.res_ln(x["a"], x["w"], x["b"], x["res"], x["g"], x["be"],
                      site, pre, out, x.get("pair"))


def _run_bwd(lib: Lib, case, x):
    if case[0] == "nt":
        return [lib.nt(**x)]
    return lib.wgrad(x["a"], x["dy"])


def _bits(t):
    import torch

    return t.view(torch.int16) if t.dtype == torch.bfloat16 else \
        t.view(torch.int32)


def _equal(xs, ys) -> bool:
    import torch

    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(xs, ys))


def _ulps(got, want) -> float:
    """max |got - want| in bf16 ulps of max |want| (want all zero: 0 if got
    is too, else inf)."""
    top = want.float().abs().max().item()
    diff = (got.float() - want.float()).abs().max().item()
    if top == 0:
        return 0.0 if diff == 0 else math.inf
    return diff / 2.0 ** (math.floor(math.log2(top)) - 7)


def check(libs: dict) -> tuple[dict, dict, dict]:
    """Hold every variant against the plain twins at CHECKS and BWD_CHECKS;
    returns ``({name: passed the gates}, {name: ran with no launch error},
    {name: forward cases whose bits differ from the first variant's})``,
    and reports the backward's differing cases."""
    import torch

    from nylon_amt_tpu_torch.ops import layer_fused as lf
    from nylon_amt_tpu_torch.ops import layer_fused_train as lft

    ok = {name: True for name in libs}
    ran = {name: True for name in libs}
    differ = {name: 0 for name in libs}
    differ_bwd = {name: 0 for name in libs}
    for case in CHECKS + BWD_CHECKS:
        fwd = case in CHECKS
        if fwd:
            kind, m, k, n, relu, drop, pre, out = case
            x = inputs(m, k, n, seed=m + k + n)
            site = lft._site(DROP_SEED, 3, n, RATE, torch.bfloat16) if drop \
                else None
            if kind == "bias":
                want = [lf.gemm_bias_plain(x["a"], x["w"], x["b"], relu,
                                           site)]
            else:
                y, p = lf.gemm_res_ln_plain(x["a"], x["w"], x["b"], x["res"],
                                            x["g"], x["be"], site)
                want = ([y] if out else []) + ([p] if pre else [])
        else:
            x = bwd_inputs(case, seed=sum(c for c in case[1:4]))
            if case[0] == "nt":
                want = [lft.gemm_nt_plain(**x)]
            else:
                want = lft.weight_grad_plain(x["a"], x["dy"])
                truth = (x["a"].double().t() @ x["dy"].double(),
                         x["dy"].double().sum(0))
        first = None
        for name, lib in libs.items():
            try:
                if fwd:
                    got, again = _run(lib, case, x, site), \
                        _run(lib, case, x, site)
                else:
                    got, again = _run_bwd(lib, case, x), \
                        _run_bwd(lib, case, x)
                torch.cuda.synchronize()
            except Refused:
                print(f"check {name} {case}: refused (a shape it does not "
                      "take)", flush=True)
                continue
            except RuntimeError as e:
                print(f"check {name} {case}: {e}", flush=True)
                ok[name] = ran[name] = False
                continue
            ok[name] &= _equal(got, again)
            if case[0] == "wg":
                dist = [(g_.double() - t).abs().max().item()
                        for g_, t in zip(got, truth)]
                lims = [2 * (p_.double() - t).abs().max().item()
                        + 1e-6 * t.abs().max().item()
                        for p_, t in zip(want, truth)]
                ok[name] &= all(d <= lim for d, lim in zip(dist, lims))
                what = ("dW, bias from float64: " + ", ".join(
                    f"{d:.3e} (limit {lim:.3e})"
                    for d, lim in zip(dist, lims)))
            else:
                worst = max(_ulps(g_, w_) for g_, w_ in zip(got, want))
                ok[name] &= worst <= ULPS
                what = f"{worst:.2f} ulps from the plain twin"
            if first is None:
                first = got
            elif not _equal(got, first):
                (differ if fwd else differ_bwd)[name] += 1
            print(f"check {name} {case}: {what}", flush=True)
    for name in libs:
        print(f"check {name}: {'passed' if ok[name] else 'FAILED'}"
              + (f"; forward: {differ[name]} of {len(CHECKS)} cases, "
                 f"backward: {differ_bwd[name]} of {len(BWD_CHECKS)}, "
                 "differ from the first variant's bits"
                 if name != next(iter(libs)) else ""), flush=True)
    return ok, ran, differ


def f64_twin(case, x, site):
    """The float64 truth of an f32 GEMM case on the same f32 operands (the
    plain twins' op sequence with every rounding dropped)."""
    import torch

    from nylon_amt_tpu_torch.ops.layer_fused import _site_mask

    kind, relu, pre, out = case[0], case[4], case[6], case[7]
    d = {k: v.double() for k, v in x.items() if k != "pair"}
    y = d["a"] @ d["w"] + d["b"]
    if relu:
        y = torch.relu(y)
    if site is not None:
        y = y * _site_mask(site, y)
    if kind == "bias":
        return [y]
    s = d["res"] + y
    mu = s.mean(-1, keepdim=True)
    var = (s - mu).square().mean(-1, keepdim=True)
    z = (s - mu) / torch.sqrt(var + 1e-5) * d["g"] + d["be"]
    return ([z] if out else []) + ([s] if pre else [])


def check_f32(libs: dict) -> dict:
    """Hold every variant's f32 forward GEMMs at F32_CHECKS within F32_REL
    of max(1, max |plain f32 twin|), two runs bit-identical; prints the
    kernel's and the twin's distances from the float64 truth (of max(1,
    max |truth|)). Returns ``{name: passed}``."""
    import torch

    from nylon_amt_tpu_torch.ops import layer_fused as lf
    from nylon_amt_tpu_torch.ops import layer_fused_train as lft
    from nylon_amt_tpu_torch.ops.precision import full_f32

    def rel(got, want):
        top = max(1.0, want.double().abs().max().item())
        return (got.double() - want.double()).abs().max().item() / top

    ok = {name: True for name in libs}
    f32 = torch.float32
    for case in F32_CHECKS:
        kind, m, k, n, relu, drop, pre, out = case
        x = inputs(m, k, n, seed=m + k + n + 1, dtype=f32)
        site = lft._site(DROP_SEED, 3, n, RATE, f32) if drop else None
        with full_f32():
            if kind == "bias":
                want = [lf.gemm_bias_plain(x["a"], x["w"], x["b"], relu,
                                           site)]
            else:
                y, p = lf.gemm_res_ln_plain(x["a"], x["w"], x["b"], x["res"],
                                            x["g"], x["be"], site)
                want = ([y] if out else []) + ([p] if pre else [])
        truth = f64_twin(case, x, site)
        plain64 = max(rel(w_, t) for w_, t in zip(want, truth))
        for name, lib in libs.items():
            try:
                got, again = _run(lib, case, x, site), _run(lib, case, x,
                                                            site)
                torch.cuda.synchronize()
            except Refused:
                print(f"f32 {name} {case}: refused", flush=True)
                continue
            except RuntimeError as e:
                print(f"f32 {name} {case}: {e}", flush=True)
                ok[name] = False
                continue
            err = max(rel(g_, w_) for g_, w_ in zip(got, want))
            e64 = max(rel(g_, t) for g_, t in zip(got, truth))
            same = _equal(got, again)
            ok[name] &= err <= F32_REL and same
            print(f"f32 {name} {case}: {err:.3e} of max(1, |plain f32|) "
                  f"(<= {F32_REL}); from float64 kernel {e64:.3e}, plain f32 "
                  f"{plain64:.3e}; reruns "
                  f"{'bit-identical' if same else 'DIFFER'}", flush=True)
        del x, want, truth
    for m, k, n in QKV_CHECKS:
        x = inputs(m, k, n, seed=m + k + n + 2, dtype=f32)
        with full_f32():
            want = lf.gemm_bias_plain(x["a"], x["w"], x["b"])
        truth = f64_twin(("bias", m, k, n, 0, 0, 0, 1), x, None)[0]
        plain64 = rel(want, truth)
        for name, lib in libs.items():
            try:
                got, again = lib.qkv(x["a"], x["w"], x["b"]), \
                    lib.qkv(x["a"], x["w"], x["b"])
                torch.cuda.synchronize()
            except (Refused, RuntimeError) as e:
                print(f"f32 {name} qkv stem [{m},{k},{n}]: {e!r}", flush=True)
                ok[name] = False
                continue
            err, e64 = rel(got[0], want), rel(got[0], truth)
            same = _equal(got, again)
            ok[name] &= err <= F32_REL and same
            print(f"f32 {name} qkv stem [{m},{k},{n}]: {err:.3e} of max(1, "
                  f"|plain f32|) "
                  f"(<= {F32_REL}); from float64 kernel {e64:.3e}, plain f32 "
                  f"{plain64:.3e}; reruns "
                  f"{'bit-identical' if same else 'DIFFER'}", flush=True)
        del x, want, truth
        torch.cuda.empty_cache()
    for name in libs:
        print(f"f32 {name}: {'passed' if ok[name] else 'FAILED'}",
              flush=True)
    return ok


def check_f32_bwd(libs: dict) -> dict:
    """Hold every variant's f32 dX and dW at F32_BWD_CHECKS: dX within
    F32_REL of max(1, max |plain f32 twin|), dW and its bias sums no
    further from the float64 truth than twice the plain f32 twin's own
    distance + 1e-6 max |truth|, two runs bit-identical. Returns ``{name:
    passed}``."""
    import torch

    from nylon_amt_tpu_torch.ops import layer_fused_train as lft
    from nylon_amt_tpu_torch.ops.precision import full_f32

    ok = {name: True for name in libs}
    for case in F32_BWD_CHECKS:
        x = bwd_inputs(case, seed=sum(case[1:4]) + 3, dtype=torch.float32)
        with full_f32():
            if case[0] == "nt":
                want = [lft.gemm_nt_plain(**{k: v for k, v in x.items()
                                             if k != "pair"})]
                truth = [lft.gemm_nt_plain(
                    **{k: v.double() if torch.is_tensor(v) else v
                       for k, v in x.items() if k != "pair"})]
            else:
                want = list(lft.weight_grad_plain(x["a"], x["dy"]))
                truth = [x["a"].double().t() @ x["dy"].double(),
                         x["dy"].double().sum(0)]
        for name, lib in libs.items():
            try:
                got, again = _run_bwd(lib, case, x), _run_bwd(lib, case, x)
                torch.cuda.synchronize()
            except (Refused, RuntimeError) as e:
                print(f"f32 bwd {name} {case}: {e!r}", flush=True)
                ok[name] = False
                continue
            same = _equal(got, again)
            if case[0] == "nt":
                top = max(1.0, want[0].abs().max().item())
                err = (got[0] - want[0]).abs().max().item() / top
                e64 = (got[0].double() - truth[0]).abs().max().item() / top
                p64 = (want[0].double() - truth[0]).abs().max().item() / top
                passed = err <= F32_REL
                what = (f"{err:.3e} of max(1, |plain f32|) (<= {F32_REL}); "
                        f"from float64 kernel {e64:.3e}, plain f32 {p64:.3e}")
            else:
                dist = [(g_.double() - t).abs().max().item()
                        for g_, t in zip(got, truth)]
                lims = [2 * (w_.double() - t).abs().max().item()
                        + 1e-6 * t.abs().max().item()
                        for w_, t in zip(want, truth)]
                passed = all(d <= lim for d, lim in zip(dist, lims))
                what = "dW, bias from float64: " + ", ".join(
                    f"{d:.3e} (limit {lim:.3e})" for d, lim in zip(dist, lims))
            ok[name] &= passed and same
            print(f"f32 bwd {name} {case}: {what}; reruns "
                  f"{'bit-identical' if same else 'DIFFER'}", flush=True)
        del x, want, truth
        torch.cuda.empty_cache()
    for name in libs:
        print(f"f32 bwd {name}: {'passed' if ok[name] else 'FAILED'}",
              flush=True)
    return ok


def check_q8(libs: dict) -> dict:
    """Hold every variant's int8 GEMMs at Q8_CHECKS: the GEMM + bias bit
    for bit equal to ``gemm_q8_bias_plain``, its row codes and scales
    ``gemm_q8_bias_codes_plain``'s (a variant without them is not run at
    those cases); the LayerNorm one within ULPS bf16 ulps of
    ``gemm_q8_res_ln_plain`` (f32: F32_REL of max(1, |plain|)), its codes
    and scales ``_quant_rows`` of its own output; two runs bit-identical.
    Returns ``{name: passed}``."""
    import torch

    from nylon_amt_tpu_torch.ops import layer_fused_q8 as lq

    ok = {name: True for name in libs}
    for case in Q8_CHECKS:
        kern, m, k, n, relu, var, dt_ = case
        dt = torch.bfloat16 if dt_ == "bf16" else torch.float32
        ln = kern == "ln"
        x = q8_inputs(m, k, n, ln, dt, seed=m + k + n + 4)
        args = (x["aq"], x["sa"], x["wq"], x["sw"], x["bias"])
        if ln:
            want = lq.gemm_q8_res_ln_plain(*args, x["res"], x["g"],
                                           x["be"])[0]
        elif var:
            want, want_q, want_s = lq.gemm_q8_bias_codes_plain(
                *args, relu, var[0], var[1])
        else:
            want = lq.gemm_q8_bias_plain(*args, relu)
        for name, lib in libs.items():
            if var and not ln and not lib.q8_codes:
                continue
            try:
                got, again = lib.q8(x, relu, var), lib.q8(x, relu, var)
                torch.cuda.synchronize()
            except (Refused, RuntimeError) as e:
                print(f"q8 {name} {case}: {e!r}", flush=True)
                ok[name] = False
                continue
            def written(res):  # a codes run writes no T code columns
                return [t[:, var[0] * var[1]:] if i == 0 and var and not ln
                        else t for i, t in enumerate(res) if t is not None]
            same = _equal(written(got), written(again))
            if not ln and var:
                nc = var[0] * var[1]
                passed = torch.equal(got[1], want_q) and torch.equal(
                    got[2], want_s) and (got[0] is None or torch.equal(
                        got[0][:, nc:], want[:, nc:]))
                what = ("codes, scales and T columns bit-identical"
                        if passed else "codes, scales or T columns DIFFER")
            elif not ln:
                passed = _equal(got, [want])
                what = "bit-identical" if passed else "NOT bit-identical"
            elif dt == torch.bfloat16:
                u = _ulps(got[0], want)
                passed, what = u <= ULPS, f"{u:.2f} ulps"
            else:
                top = max(1.0, want.abs().max().item())
                e = (got[0] - want).abs().max().item() / top
                passed, what = e <= F32_REL, f"{e:.2e} of max(1, |plain|)"
            if ln and var:
                q, sc = lq._quant_rows(got[0])
                exact = torch.equal(got[1], q) and torch.equal(got[2],
                                                               sc[:, 0])
                passed &= exact
                what += f", codes {'exact' if exact else 'DIFFER'}"
            ok[name] &= passed and same
            print(f"q8 {name} {case}: {what} from the plain twin; reruns "
                  f"{'bit-identical' if same else 'DIFFER'}", flush=True)
        del x, want
        torch.cuda.empty_cache()
    for name in libs:
        print(f"q8 {name}: {'passed' if ok[name] else 'FAILED'}", flush=True)
    return ok


def timing_q8(libs: dict) -> None:
    """Each variant's int8 GEMMs at the 43 products of PAPER_Q8 in bf16, A
    B .. B A by ``graph_ms``, beside the bound (bytes, or the int8 products
    at 1,979 TOP/s) and ``torch._int_mm``; and the totals of one forward.
    Then the attention at Q8_ATTENTION the same way: a variant with the
    row codes writes its output's codes and scales (the forward's variant),
    one without them its output in T; the bound counts the codes'."""
    import torch

    names = list(libs)
    total = dict.fromkeys(names + ["bound", "_int_mm"], 0.0)
    for label, kern, m, k, n, relu, var, count in PAPER_Q8:
        ln = kern == "gemm_q8_res_ln"
        x = q8_inputs(m, k, n, ln, torch.bfloat16)
        ms = _abba(names, lambda name: libs[name].q8(x, relu, var), graph_ms)
        mm = graph_ms(lambda: torch._int_mm(x["aq"], x["wq"]))
        size = 2 * m * n  # T out
        if not ln and var:  # the segments as codes, the rest (if any) in T
            size = m * var[0] * var[1] + 4 * var[1] * m + 2 * m * (
                n - var[0] * var[1]) * var[2]
        nbytes = m * k + 4 * m + n * k + 4 * n + 2 * n + size
        if ln:
            nbytes += 2 * m * n + 8 * n + (m * n + 4 * m if var else 0)
        bound = max(nbytes / HBM_BPS, 2 * m * k * n / INT8_OPS) * 1e3
        _line(f"q8 {kern} {label}" + (f" {var}" if var else ""),
              f"[{m},{k},{n}]", count, ms, bound, f"_int_mm {mm:.3f}")
        for name, t in ms.items():
            total[name] += count * t
        total["bound"] += count * bound
        total["_int_mm"] += count * mm
        del x
        torch.cuda.empty_cache()
    print("time of one int8 forward's 43 s8 GEMMs (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in total.items()), flush=True)
    total = dict.fromkeys(names + ["bound"], 0.0)
    hid, heads = 256, 4
    for label, n, lq, lk, count in Q8_ATTENTION:
        a = q8_attention_inputs(n, lq, lk, hid, heads, torch.bfloat16)
        ms = _abba(names, lambda name: libs[name].attention_q8(a), graph_ms)
        bound = attention_q8_bytes(n, lq, lk, hid) / HBM_BPS * 1e3
        _line(f"q8 attention {label}", f"[{n},{lq},{lk}]", count, ms, bound,
              "no library call")
        for name, t in ms.items():
            total[name] += count * t
        total["bound"] += count * bound
        del a
        torch.cuda.empty_cache()
    print("time of one int8 forward's 11 attention launches (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in total.items()), flush=True)


def ln_inputs(m, n, dtype, drop, seed=0):
    """Seeded dy, the pre-LN sum s (``dtype``), f32 gamma, and the dropout
    site of the step's FFN output (rate 0.1) or None."""
    import torch

    from nylon_amt_tpu_torch.ops import layer_fused_train as tlt

    g = torch.Generator(device="cuda").manual_seed(seed)
    dy = torch.randn((m, n), generator=g, device="cuda").to(dtype)
    s = (3 * torch.randn((m, n), generator=g, device="cuda") + 0.5).to(dtype)
    gamma = 1 + 0.1 * torch.randn(n, generator=g, device="cuda")
    site = tlt._site(DROP_SEED, tlt._SITE_FFN_OUT, n, RATE, dtype) if drop \
        else None
    return dy, s, gamma, site


def check_ln(libs: dict) -> dict:
    """Hold every variant's LayerNorm backward at LN_CHECKS against
    ``ln_bwd_plain``: da and dam within ULPS bf16 ulps (f32: F32_REL of
    max(1, |plain|)), dam bit for bit T(da x keep) of its own da, dgamma
    and dbeta (its partials summed) within 1e-4 of max |plain|; two runs
    bit-identical. Returns ``{name: passed}``."""
    import torch

    from nylon_amt_tpu_torch.ops import layer_fused as lf
    from nylon_amt_tpu_torch.ops import layer_fused_train as tlt

    ok = {name: True for name in libs}
    for m, n, dt_, drop in LN_CHECKS:
        dt = torch.bfloat16 if dt_ == "bf16" else torch.float32
        dy, s, g, site = ln_inputs(m, n, dt, drop, seed=m + n)
        want = tlt.ln_bwd_plain(dy, s, g, site)
        for name, lib in libs.items():
            try:
                got, again = lib.ln_bwd(dy, s, g, site), \
                    lib.ln_bwd(dy, s, g, site)
                torch.cuda.synchronize()
            except (Refused, RuntimeError) as e:
                print(f"ln {name} {(m, n, dt_, drop)}: {e!r}", flush=True)
                ok[name] = False
                continue
            same = _equal(got, again)
            errs, passed = [], True
            for a, b in zip(got[:-1], want[:2]):
                if dt == torch.bfloat16:
                    u = _ulps(a, b)
                    passed &= u <= ULPS
                    errs.append(f"{u:.2f} ulps")
                else:
                    e = (a - b).abs().max().item() / max(
                        1.0, b.abs().max().item())
                    passed &= e <= F32_REL
                    errs.append(f"{e:.1e}")
            if drop:
                exact = torch.equal(got[1], (got[0] * lf._site_mask(
                    site, got[0])).to(dt))
                passed &= exact
                errs.append("dam T(da x keep)" if exact else "dam DIFFERS")
            sums = got[-1].sum(1)
            rel = max((a - b).abs().max().item() / b.abs().max().item()
                      for a, b in zip(sums, want[2:]))
            passed &= rel <= 1e-4
            ok[name] &= passed and same
            print(f"ln {name} [{m}, {n}] {dt_}{' drop' if drop else ''}: "
                  f"{', '.join(errs)}; dgamma/dbeta {rel:.1e}; reruns "
                  f"{'bit-identical' if same else 'DIFFER'}"
                  f"{'' if passed else '; FAILED'}", flush=True)
        del dy, s, want
        torch.cuda.empty_cache()
    for name in libs:
        print(f"ln {name}: {'passed' if ok[name] else 'FAILED'}", flush=True)
    return ok


def timing_ln(libs: dict) -> None:
    """Each variant's LayerNorm backward A B .. B A by ``graph_ms`` at every
    launch shape of the paper bf16 and the default f32 batch-8 steps
    (``ln_step_shapes``), with the steps' dropout site and without, beside
    the bytes bound and ``native_layer_norm_backward`` (without dropout);
    and each step's launches summed."""
    import torch

    from nylon_amt_tpu_torch.config import Config, ModelConfig
    from nylon_amt_tpu_torch.ops.layer_fused import _LN_EPS

    names = list(libs)
    for label, dt, m_cfg in (
            ("paper bf16", torch.bfloat16, ModelConfig.paper_scale()),
            ("default f32", torch.float32, Config().model)):
        n = m_cfg.hid_dim
        for drop in (True, False):
            total = dict.fromkeys(names + ["bound", "library"], 0.0)
            for m, count in ln_step_shapes(m_cfg):
                dy, s, g, site = ln_inputs(m, n, dt, drop)
                ms = _abba(names, lambda name: libs[name].ln_bwd(
                    dy, s, g, site), graph_ms)
                nbytes = dy.numel() * dy.element_size() * (4 if drop else 3)
                bound = nbytes / HBM_BPS * 1e3
                lib = "the library computes no keep mask"
                if not drop:
                    w, zero = g.to(dt), torch.zeros(n, dtype=dt,
                                                    device="cuda")
                    _, mean, rstd = torch.ops.aten.native_layer_norm(
                        s, [n], w, zero, _LN_EPS)
                    lib_ms = graph_ms(
                        lambda: torch.ops.aten.native_layer_norm_backward(
                            dy, s, [n], mean, rstd, w, zero,
                            [True, True, True]))
                    total["library"] += count * lib_ms
                    lib = f"native_layer_norm_backward {lib_ms:.3f}"
                _line(f"ln_bwd {label}{' drop' if drop else ''}",
                      f"[{m},{n}]", count, ms, bound, lib)
                for name, t in ms.items():
                    total[name] += count * t
                total["bound"] += count * bound
                del dy, s
                torch.cuda.empty_cache()
            print(f"time of one {label} step's LayerNorm backward "
                  f"{'with' if drop else 'without'} dropout (ms): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in total.items()),
                  flush=True)


def check_q8_cols(libs: dict) -> dict:
    """Hold every variant's V quantizer at Q8_COLS_CHECKS, on V's strided
    view of a packed QKV or KV output, in bf16 and f32: its codes and
    scales bit for bit ``quant_cols_plain``'s (zero codes past Lk
    included), two runs bit-identical. Returns ``{name: passed}``."""
    import torch

    from nylon_amt_tpu_torch.ops import layer_fused_q8 as lq

    ok = {name: True for name in libs}
    for hid, width, n, lk in Q8_COLS_CHECKS:
        for dt in (torch.bfloat16, torch.float32):
            g = torch.Generator(device="cuda").manual_seed(hid + n + lk)
            x = torch.randn((n * lk, width * hid), generator=g,
                            device="cuda").to(dt)
            v = x[:, (width - 1) * hid:]
            want = lq.quant_cols_plain(v, n)
            for name, lib in libs.items():
                try:
                    got, again = lib.quant_cols(v, n), lib.quant_cols(v, n)
                    torch.cuda.synchronize()
                except (Refused, RuntimeError) as e:
                    print(f"q8 cols {name}: {e!r}", flush=True)
                    ok[name] = False
                    continue
                passed = _equal(got, list(want)) and _equal(got, again)
                ok[name] &= passed
                print(f"q8 cols {name} hid {hid} [{n} x {lk}] {dt}: "
                      f"{'bit for bit' if passed else 'DIFFERS'}",
                      flush=True)
    for name in libs:
        print(f"q8 cols {name}: {'passed' if ok[name] else 'FAILED'}",
              flush=True)
    return ok


def timing_q8_cols(libs: dict) -> None:
    """Each variant's V quantizer A B .. B A by ``graph_ms`` at the paper
    int8 forward's four attention shapes (Q8_ATTENTION: V's strided view)
    in bf16 and f32, beside the bytes bound (one read of V, the codes and
    the scales written); and the forward's 11 launches summed."""
    import torch

    names = list(libs)
    hid = 256
    for dt in (torch.bfloat16, torch.float32):
        total = dict.fromkeys(names + ["bound"], 0.0)
        for label, n, _, lk, count in Q8_ATTENTION:
            width = 3 if label.endswith("self") else 2
            g = torch.Generator(device="cuda").manual_seed(lk)
            x = torch.randn((n * lk, width * hid), generator=g,
                            device="cuda").to(dt)
            v = x[:, (width - 1) * hid:]
            ms = _abba(names, lambda name: libs[name].quant_cols(v, n),
                       graph_ms)
            bound = (n * lk * hid * x.element_size()
                     + n * hid * (-(-lk // 32) * 32) + 4 * n * hid) \
                / HBM_BPS * 1e3
            _line(f"quant_cols {str(dt).removeprefix('torch.')}",
                  f"[{n},{lk},{hid}]", count, ms, bound, "no library call")
            for name, t in ms.items():
                total[name] += count * t
            total["bound"] += count * bound
            del x, v
            torch.cuda.empty_cache()
        print(f"time of one int8 forward's 11 V quantizer launches, {dt} "
              f"(ms): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                    total.items()), flush=True)


# (rows, d2, row0) the mask kernel is held at: packed rows (256, 512, 768
# wide), unpacked ones (the paper and the default widths, odd widths), a
# flat tail under a vector, a few items or thousands a thread
HASH_CHECKS = [(1003, 256, 0), (77, 512, 2), (5, 768, 0), (1003, 88, 0),
               (4099, 128, 1), (333, 96, 0), (31, 7, 0), (3, 3, 5),
               (262144, 256, 0), (90112, 88, 0)]
# (label, rows, d2, dtype, x * mask, launches a step): the embedding-dropout
# launches of the paper bf16 and the default f32 batch-8 fused steps (the
# forward and the backward's recompute of each stage), then the per-site
# models' activation sites at the paper widths
HASH_TIMES = [("paper step, freq", 262144, 256, "bf16", True, 2),
              ("paper step, time", 90112, 256, "bf16", True, 2),
              ("default f32 step, freq", 262144, 64, "f32", True, 2),
              ("default f32 step, time", 90112, 64, "f32", True, 2),
              ("per-site FFN mid, freq", 262144, 512, "bf16", True, 0),
              ("per-site FFN mid, time", 90112, 512, "bf16", True, 0),
              ("mask only, probabilities", 90112, 88, "f32", False, 0)]


def check_hash(libs: dict) -> dict:
    """Hold every variant's mask kernel at HASH_CHECKS in bf16 and f32, the
    mask and x * mask, bit for bit against ``hash_keep_mask_plain``; two
    runs bit-identical. Returns ``{name: passed}``."""
    import torch

    from nylon_amt_tpu_torch.ops import attention as att

    ok = {name: True for name in libs}
    for (rows, d2, row0), dt, with_x in (
            (c, dt, wx) for c in HASH_CHECKS
            for dt in (torch.bfloat16, torch.float32) for wx in (False, True)):
        g = torch.Generator(device="cuda").manual_seed(rows + d2)
        x = torch.randn((rows, d2), generator=g, device="cuda").to(dt) \
            if with_x else None
        want = att.hash_keep_mask_plain(DROP_SEED, 5, row0, (1, rows, d2),
                                        RATE, dt, "cuda")[0]
        if with_x:
            want = x * want
        for name, lib in libs.items():
            try:
                got = [lib.hash_mask(x, rows, d2, dt, DROP_SEED, 5, row0, RATE)
                       for _ in range(2)]
                torch.cuda.synchronize()
            except (Refused, RuntimeError) as e:
                print(f"hash {name} {(rows, d2, row0)}: {e!r}", flush=True)
                ok[name] = False
                continue
            same = _equal(got[:1], got[1:])
            passed = same and _equal(got[:1], [want])
            ok[name] &= passed
            if not passed:
                print(f"hash {name} [{rows}, {d2}] row0 {row0} {dt}"
                      f"{' x * mask' if with_x else ''}: "
                      f"{(got[0] != want).sum().item()} elements differ"
                      f"{'' if same else ', reruns DIFFER'}", flush=True)
    exact = "bit for bit, reruns bit-identical"
    for name in libs:
        print(f"hash {name}: {len(HASH_CHECKS) * 4} cases "
              f"{exact if ok[name] else 'FAILED'}", flush=True)
    return ok


def timing_hash(libs: dict) -> None:
    """Each variant's mask kernel A B .. B A by ``graph_ms`` at HASH_TIMES
    beside the bytes bound (x read once, the output written once), and the
    two fused steps' launches summed."""
    import torch

    names = list(libs)
    total = {}
    for label, rows, d2, dt_, with_x, count in HASH_TIMES:
        dt = torch.bfloat16 if dt_ == "bf16" else torch.float32
        x = torch.randn((rows, d2), device="cuda").to(dt) if with_x else None
        ms = _abba(names, lambda name: libs[name].hash_mask(
            x, rows, d2, dt, DROP_SEED, 6, 0, RATE), graph_ms)
        bound = rows * d2 * dt.itemsize * (2 if with_x else 1) / HBM_BPS * 1e3
        _line(f"hash_mask {label} {dt_}{' x * mask' if with_x else ''}",
              f"[{rows},{d2}]", count, ms, bound, "no library call")
        if count:
            step = total.setdefault(label.split(",")[0],
                                    dict.fromkeys(names + ["bound"], 0.0))
            for name, t in ms.items():
                step[name] += count * t
            step["bound"] += count * bound
        del x
        torch.cuda.empty_cache()
    for step, t in total.items():
        print(f"time of the {step}'s 4 mask launches (ms): "
              + ", ".join(f"{k} {v:.3f}" for k, v in t.items()), flush=True)


# (P, n) segment lists the reduction is held at: one and two segments,
# columns not a multiple of 4, tiles of every width, a tall LayerNorm one
REDUCE_CHECKS = [[(11, 196608), (22, 768)], [(528, 256), (528, 256)],
                 [(5, 10)], [(7, 1030), (1, 4)], [(33, 4096), (66, 64)],
                 [(792, 64), (792, 64)], [(16, 131072), (16, 512)]]


def reduce_inputs(segs, seed=0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((p, n), generator=g, device="cuda") * 100
            for p, n in segs]


def check_reduce(libs: dict) -> dict:
    """Hold every variant's reduction at REDUCE_CHECKS bit for bit against
    ``reduce_rows_plain``; two runs bit-identical. Returns ``{name:
    passed}``."""
    import torch

    from nylon_amt_tpu_torch.ops.layer_fused_train import reduce_rows_plain

    ok = {name: True for name in libs}
    for i, segs in enumerate(REDUCE_CHECKS):
        parts = reduce_inputs(segs, seed=i)
        want = reduce_rows_plain(parts)
        for name, lib in libs.items():
            try:
                got, again = lib.reduce(parts), lib.reduce(parts)
                torch.cuda.synchronize()
            except (Refused, RuntimeError) as e:
                print(f"reduce {name} {segs}: {e!r}", flush=True)
                ok[name] = False
                continue
            passed = _equal(got, want) and _equal(got, again)
            ok[name] &= passed
            print(f"reduce {name} {segs}: " + (
                "bit for bit, reruns bit-identical" if passed
                else "DIFFERS"), flush=True)
    for name in libs:
        print(f"reduce {name}: {'passed' if ok[name] else 'FAILED'}",
              flush=True)
    return ok


def timing_reduce(libs: dict) -> None:
    """Each variant's reduction A B .. B A by ``graph_ms`` at every launch
    of the paper bf16 and the default f32 batch-8 steps
    (``reduce_step_segments``), beside the bytes bound (each partial read
    once, the sums written once) and ``parts.sum(0)`` of each segment; and
    each step's launches summed."""
    import torch

    from nylon_amt_tpu_torch.config import Config, ModelConfig

    names = list(libs)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, dt, m_cfg in (
            ("paper bf16", torch.bfloat16, ModelConfig.paper_scale()),
            ("default f32", torch.float32, Config().model)):
        total = dict.fromkeys(names + ["bound", "parts.sum(0)"], 0.0)
        launches = 0
        for what, segs, count in reduce_step_segments(m_cfg, dt, sms):
            parts = reduce_inputs(segs)
            ms = _abba(names, lambda name: libs[name].reduce(parts),
                       graph_ms)
            lib_ms = graph_ms(lambda: [p.sum(0) for p in parts])
            bound = sum(p * n + n for p, n in segs) * 4 / HBM_BPS * 1e3
            _line(f"reduce_rows {label} {what}", str(segs), count, ms, bound,
                  f"parts.sum(0) {lib_ms:.4f}")
            for name, t in ms.items():
                total[name] += count * t
            total["bound"] += count * bound
            total["parts.sum(0)"] += count * lib_ms
            launches += count
            del parts
            torch.cuda.empty_cache()
        print(f"time of one {label} step's {launches} reduction launches "
              f"(ms): " + ", ".join(f"{k} {v:.3f}" for k, v in total.items()),
              flush=True)


def attention_inputs(n, lq, lk, hid, dtype, seed=0, packed=False):
    """Seeded q, k, v, do ``[n, L, hid]`` in ``dtype`` on the card; with
    ``packed`` (lq == lk) q, k, v are the column slices of one ``[n, L, 3
    hid]`` QKV, as a self-attention layer reads them (row stride 3 hid)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    if packed:
        qkv = torch.randn((n, lq, 3 * hid), generator=g,
                          device="cuda").to(dtype)
        do = torch.randn((n, lq, hid), generator=g, device="cuda").to(dtype)
        return [qkv[..., :hid], qkv[..., hid:2 * hid], qkv[..., 2 * hid:],
                do]
    return [torch.randn((n, L, hid), generator=g, device="cuda").to(dtype)
            for L in (lq, lk, lk, lq)]


def attention_plain(q, k, v, do, heads, kind):
    """The plain twin of ``Lib.attention``'s ``kind`` (the FFMA-score kinds
    the plain forward and backward), under full_f32 for f32 inputs."""
    import contextlib

    import torch

    from nylon_amt_tpu_torch.ops import attention as att
    from nylon_amt_tpu_torch.ops.precision import full_f32

    kind = kind.removeprefix("ffma_")
    mask = None
    if kind.startswith("drop"):
        def mask(h, shape):
            return att.hash_keep_mask_plain(DROP_SEED, h, 0, shape, RATE,
                                            torch.float32, q.device)
    with (full_f32() if q.dtype == torch.float32
          else contextlib.nullcontext()):
        if kind.endswith("bwd"):
            return list(att.mha_bwd_plain(q, k, v, do, heads, ATTN_SCALE,
                                          mask))
        if kind == "probs":
            return list(att.mha_plain(q, k, v, heads, ATTN_SCALE,
                                      with_probs=True))
        return [att.mha_plain(q, k, v, heads, ATTN_SCALE, mask)]


def check_attn(libs: dict, part: str) -> dict:
    """Hold every variant's attention of ``part`` (each kind of ATTN_KINDS
    it has) at 16 sequences of each site of ATTN16_SITES, at 4 heads of 64,
    2 heads of 32 and 3 heads of 32 (the self sites on packed QKV views,
    row stride 3 hid), and at 4 sequences of each ATTN16_ODD (Lq, Lk) at 4
    heads of 64 and 3 of 32, against ``attention_plain``. bf16, under (l)'s
    limits: each output within ULPS bf16 ulps of the plain twin (the same
    masks under dropout), dq, dk, dv within ATTN_CHAIN_ULPS, K11's
    probabilities within ATTN_PROBS_ATOL of the plain f32 ones, rows
    summing to 1 within it. f32, under (n.1)'s: outputs within
    ATTN32_OUT_REL of max(1, max |plain|), input grads within
    ATTN32_GRAD_REL of max |plain|, K11's probabilities within
    ATTN32_PROBS_ATOL and its rows within ATTN32_ROW_ATOL. Both: K11's
    output K10's bit for bit, two runs bit-identical. Returns ``{name:
    passed}``."""
    import torch

    f32 = part == "attn32"
    dtype = torch.float32 if f32 else torch.bfloat16
    p_atol, r_atol = ((ATTN32_PROBS_ATOL, ATTN32_ROW_ATOL) if f32
                      else (ATTN_PROBS_ATOL, ATTN_PROBS_ATOL))
    ok = {name: True for name in libs}
    cases = [(hid, heads, 16, label, lq, lk) for hid, heads in (
        (256, 4), (64, 2), (96, 3)) for label, lq, lk, _ in ATTN16_SITES]
    cases += [(hid, heads, 4, f"[{lq}, {lk}]", lq, lk) for hid, heads in (
        (256, 4), (96, 3)) for lq, lk in ATTN16_ODD]
    for hid, heads, n, label, lq, lk in cases:
        q, k, v, do = attention_inputs(n, lq, lk, hid, dtype,
                                       seed=lq + lk + hid, packed=lq == lk)
        for kind in ATTN_KINDS[part]:
            want = attention_plain(q, k, v, do, heads, kind)
            for name, lib in libs.items():
                if kind not in lib.attention_kinds(part):
                    continue
                try:
                    got = lib.attention(part, q, k, v, heads, kind, do)
                    again = lib.attention(part, q, k, v, heads, kind, do)
                    torch.cuda.synchronize()
                except (Refused, RuntimeError) as e:
                    print(f"{part} {name} {label} hid {hid} {kind}: {e!r}",
                          flush=True)
                    ok[name] = False
                    continue
                same = _equal(got, again)
                bwd = kind.endswith("bwd")
                if f32:
                    errs = [(a - b).abs().max().item()
                            / max(b.abs().max().item(), 0.0 if bwd else 1.0,
                                  1e-30)
                            for a, b in zip(got[:1] if kind == "probs"
                                            else got, want)]
                    limit = ATTN32_GRAD_REL if bwd else ATTN32_OUT_REL
                    what = "/".join(f"{e:.2e}" for e in errs)
                else:
                    errs = [_ulps(a, b) for a, b in zip(got[:3], want[:3])
                            if a.dtype == torch.bfloat16]
                    limit = ATTN_CHAIN_ULPS if bwd else ULPS
                    what = "/".join(f"{u:.2f}" for u in errs) + " ulps"
                passed = same and max(errs) <= limit
                if kind == "probs":
                    k10 = lib.attention(part, q, k, v, heads, "fwd")[0]
                    p_err = (got[1] - want[1]).abs().max().item()
                    r_err = (got[1].sum(-1) - 1).abs().max().item()
                    eq = torch.equal(got[0], k10)
                    passed &= eq and p_err <= p_atol and r_err <= r_atol
                    what += (f", output {'=' if eq else '!='} K10's, "
                             f"probs {p_err:.2e}, rows {r_err:.2e}")
                ok[name] &= passed
                print(f"{part} {name} {label} hid {hid} {kind}: {what} from "
                      f"the plain twin (<= {limit}); reruns "
                      f"{'bit-identical' if same else 'DIFFER'}", flush=True)
        del q, k, v, do
        torch.cuda.empty_cache()
    for name in libs:
        print(f"{part} {name}: {'passed' if ok[name] else 'FAILED'}",
              flush=True)
    return ok


def attention_bounds(part, kind, n, lq, lk, hid, heads) -> tuple:
    """(as the products run, at the least), in ms, of ``kind`` at these
    shapes: q, k, v (and dO) in, the output (and the f32 probabilities; dq,
    dk, dv) out once over HBM_BPS, or the products (2, or the backward's 5)
    over their peak, the hash of each score under dropout (8 integer
    operations) over F32_FLOPS, whichever is longer. bf16: the products at
    BF16_FLOPS (no hashes), both times alike. f32: at the least each product
    as 3 TF32 passes over TF32_FLOPS; as run, the FFMA-score kinds take the
    score product (and K11 its second pass of scores) on FFMA over
    F32_FLOPS."""
    bwd = kind.endswith("bwd")
    size = 4 if part == "attn32" else 2
    nbytes = size * n * hid * ((2 * lq + 2 * lk) if not bwd
                               else (3 * lq + 4 * lk))
    if kind == "probs":
        nbytes += 4 * n * heads * lq * lk
    prod = 2 * n * lq * lk * hid
    if part == "attn16":
        t = max(nbytes / HBM_BPS, (5 if bwd else 2) * prod / BF16_FLOPS) * 1e3
        return t, t
    hashes = 8 * n * heads * lq * lk if kind.startswith("drop") else 0
    tf32 = ((5 if bwd else 2) * 3 * prod / TF32_FLOPS + hashes / F32_FLOPS)
    ffma = prod if kind in ("ffma_fwd", "ffma_bwd", "probs") else 0
    run = tf32 - (3 * prod / TF32_FLOPS if kind != "probs" and ffma else 0) \
        + ffma / F32_FLOPS
    return (max(nbytes / HBM_BPS, run) * 1e3,
            max(nbytes / HBM_BPS, tf32) * 1e3)


def timing_attn(libs: dict, part: str) -> None:
    """Each variant's attention of ``part`` at the sites (ATTN16_SITES), A B
    .. B A by ``graph_ms``, beside the bound and SDPA
    (``F.scaled_dot_product_attention`` on the same views, f32 under
    full_f32, by CUDA events; its backward by ``autograd.grad`` over one
    recorded forward; K11 has none, the FFMA-score kinds are timed beside
    K10's). bf16: every kind at ATTN16_BATCHES, 4 heads of 64. f32: at D 32
    and 64 (ATTN32_WIDTHS), the forward kinds at batch 32 and the backward
    ones at batch 8, with the all-3xTF32 bound beside the one as run."""
    import contextlib

    import torch
    import torch.nn.functional as F

    from nylon_amt_tpu_torch.ops.precision import full_f32

    f32 = part == "attn32"
    dtype = torch.float32 if f32 else torch.bfloat16
    names = list(libs)
    widths = ATTN32_WIDTHS if f32 else ((256, 4),)
    runs = (((32, ("fwd", "probs", "drop", "ffma_fwd")),
             (8, ("bwd", "drop_bwd", "ffma_bwd"))) if f32 else
            tuple((B, ATTN16_KINDS) for B in ATTN16_BATCHES))
    for hid, heads in widths:
        d = hid // heads
        for label, lq, lk, per in ATTN16_SITES:
            for B, kinds in runs:
                n = B * per
                q, k, v, do = attention_inputs(n, lq, lk, hid, dtype)

                def sdpa(a, b, c, **kw):
                    return F.scaled_dot_product_attention(
                        *(t.view(n, -1, heads, d).transpose(1, 2)
                          for t in (a, b, c)), scale=ATTN_SCALE,
                        **kw).transpose(1, 2).reshape(n, lq, hid)

                def sdpa_bwd(**kw):
                    qq, kk, vv = (t.detach().requires_grad_()
                                  for t in (q, k, v))
                    out = sdpa(qq, kk, vv, **kw)
                    return cuda_ms(lambda: torch.autograd.grad(
                        out, (qq, kk, vv), do, retain_graph=True))

                lib_ms = {"fwd": lambda: cuda_ms(lambda: sdpa(q, k, v)),
                          "drop": lambda: cuda_ms(lambda: sdpa(
                              q, k, v, dropout_p=RATE)),
                          "bwd": sdpa_bwd,
                          "drop_bwd": lambda: sdpa_bwd(dropout_p=RATE)}
                lib_ms["ffma_fwd"] = lib_ms["fwd"]
                lib_ms["ffma_bwd"] = lib_ms["bwd"]
                with full_f32() if f32 else contextlib.nullcontext():
                    for kind in kinds:
                        have = [x for x in names
                                if kind in libs[x].attention_kinds(part)]
                        ms = _abba(have, lambda name: libs[name].attention(
                            part, q, k, v, heads, kind, do), graph_ms)
                        run, tf32 = attention_bounds(part, kind, n, lq, lk,
                                                     hid, heads)
                        sd = lib_ms[kind]() if kind in lib_ms else None
                        lib_txt = (("SDPA f32 " if f32 else "SDPA ")
                                   + ("none" if sd is None else f"{sd:.3f}")
                                   + (f" ms; all 3xTF32 bound {tf32:.3f}"
                                      if f32 else ""))
                        _line(f"{part} {kind} {label} D{d} batch {B}",
                              f"[{n},{lq},{lk}]", 1, ms, run, lib_txt)
                del q, k, v, do
                torch.cuda.empty_cache()


def attention_q8_bytes(n, lq, lk, hid) -> int:
    """The bytes the int8 attention must move: Q, K and V^T codes (the
    keys padded to 32) with their scales in; the output's codes and row
    scales out. Its int8 products (4 n Lq Lk hid) take less time at 1,979
    TOP/s at every shape of the model."""
    lk_pad = -(-lk // 32) * 32
    return (n * lq * hid + n * lk * hid + n * hid * lk_pad
            + 4 * (n * lq + n * lk + n * hid) + n * lq * hid + 4 * n * lq)


def sass(libs_paths: dict) -> dict:
    """``{name: {instantiation: its SASS}}`` of each variant's SAME_KERNELS
    (``cuobjdump -sass`` of the library that holds them), the names
    stripped of the anonymous namespace's per-build tag."""
    from nylon_amt_tpu_torch import kernels

    tool = Path(kernels.find_nvcc()).parent / "cuobjdump"
    out = {}
    for name, paths in libs_paths.items():
        funcs = {}
        for part, kernels_ in SAME_KERNELS.items():
            text = subprocess.run([str(tool), "-sass", str(paths[part])],
                                  capture_output=True, text=True,
                                  check=True).stdout
            cur = None
            for ln in text.splitlines():
                if "Function :" in ln:
                    fn = ln.split("Function :")[1].strip()
                    cur = None
                    if any(k in fn for k in kernels_):
                        cur = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "",
                                     fn)
                        funcs[cur] = []
                elif cur is not None and ln.strip():
                    # (cuobjdump pads the columns to the file's widest line)
                    funcs[cur].append(" ".join(ln.split()))
        out[name] = funcs
    return out


def cuda_ms(fn, iters=10, warmup=2) -> float:
    import torch

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


def graph_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Device time of one call of ``fn`` in ms with no host time in it:
    ``reps`` calls captured in one CUDA graph after ``warmup`` calls on
    the capture's stream, the graph replayed once to warm it, then the best
    of three replays by CUDA events, over ``reps``. For a call whose host
    work (allocation, TMA maps, the launch) can outlast its kernels, where
    back-to-back calls would time the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    best = math.inf
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    del graph
    torch.cuda.empty_cache()
    return best


def _abba(names, fn, timer=cuda_ms) -> dict:
    """Best of two times of each variant by ``timer``, in the order A B ..
    B A."""
    ms = {}
    for name in names + names[::-1]:
        ms.setdefault(name, []).append(timer(lambda: fn(name)))
    return {name: min(t) for name, t in ms.items()}


def _line(label, shape, count, ms, bound, lib_txt):
    print(f"time {label} {shape} x{count}: " + "; ".join(
        f"{name} {t:.3f} ms ({bound / t:.1%} of the bound)"
        for name, t in ms.items()) + f"; {lib_txt} ms; bound {bound:.3f} ms",
          flush=True)


def timing(libs: dict) -> None:
    """Each variant at PAPER and PAPER_STEP, in the order A B .. B A, beside
    bf16 torch.matmul of the same product (and + F.layer_norm for the
    LayerNorm GEMM) and the bound; and the totals of one forward and of
    one step's 43 dX and 43 dW products."""
    import torch
    import torch.nn.functional as F

    names = list(libs)
    total = dict.fromkeys(names + ["bound", "matmul"], 0.0)
    for label, m, k, n, relu, count in PAPER:
        x = inputs(m, k, n)
        case = ("ln" if label.startswith("ln") else "bias", m, k, n, relu, 0,
                0, 1)
        ms = _abba(names, lambda name: _run(libs[name], case, x, None))
        mm = cuda_ms(lambda: x["a"] @ x["w"])
        lib = f"matmul {mm:.3f}"
        ln = case[0] == "ln"
        if ln:
            g16, b16 = x["g"].bfloat16(), x["be"].bfloat16()
            lib += ", matmul + layer_norm " + format(cuda_ms(
                lambda: F.layer_norm(x["a"] @ x["w"] + x["b"] + x["res"],
                                     (n,), g16, b16, 1e-5)), ".3f")
        nbytes = 2 * (m * k + k * n + m * n) + (2 * m * n if ln else 0)
        bound = max(nbytes / HBM_BPS, 2 * m * k * n / BF16_FLOPS) * 1e3
        _line(label, f"[{m},{k},{n}]", count, ms, bound, lib)
        for name, t in ms.items():
            total[name] += count * t
        total["bound"] += count * bound
        total["matmul"] += count * mm
        del x
        torch.cuda.empty_cache()
    print("time of one forward's 43 GEMMs (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in total.items()), flush=True)
    totals = {kind: dict.fromkeys(names + ["bound", "matmul"], 0.0)
              for kind in ("gemm_nt", "wgrad")}
    for label, kind, m, k, n, *rest in PAPER_STEP:
        count = rest[-1]
        if kind == "gemm_nt":
            x = bwd_inputs(("nt", m, k, n, *rest[:3]))
            side = 1 if rest[0] else 0
            ms = _abba(names, lambda name: libs[name].nt(**x))
            mm = cuda_ms(lambda: x["dy"] @ x["w"].t())
            nbytes = 2 * (m * k + n * k + m * n * (1 + side))
            shape = f"[{m},{k}->{n}] " + " ".join(
                v for v, on in ((rest[0], rest[0]), ("m1", rest[1]),
                                ("m2", rest[2])) if on)
        else:
            x = bwd_inputs(("wg", m, k, n))
            ms = _abba(names, lambda name: libs[name].wgrad(x["a"], x["dy"]))
            mm = cuda_ms(lambda: (x["a"].t() @ x["dy"], x["dy"].sum(0)))
            nbytes = 2 * (m * k + m * n) + 4 * (k * n + n)
            shape = f"[{m},{k}x{n}]"
        bound = max(nbytes / HBM_BPS, 2 * m * k * n / BF16_FLOPS) * 1e3
        _line(f"{kind} {label}", shape, count, ms, bound,
              f"matmul {mm:.3f}")
        tot = totals[kind]
        for name, t in ms.items():
            tot[name] += count * t
        tot["bound"] += count * bound
        tot["matmul"] += count * mm
        del x
        torch.cuda.empty_cache()
    for kind, tot in totals.items():
        print(f"time of one step's 43 {kind} products (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in tot.items()), flush=True)


def timing_f32(libs: dict) -> None:
    """Each variant's f32 forward GEMMs at PAPER and DEFAULT, A B .. B A,
    beside f32 torch.matmul (IEEE), the bound and the FFMA bound; and the
    totals of one forward."""
    import torch

    from nylon_amt_tpu_torch.ops.precision import full_f32

    names = list(libs)
    for geo, table in (("paper", PAPER), ("default", DEFAULT)):
        total = dict.fromkeys(names + ["bound", "matmul", "ffma"], 0.0)
        for label, m, k, n, relu, count in table:
            x = inputs(m, k, n, dtype=torch.float32)
            ln = label.startswith("ln")
            case = ("ln" if ln else "bias", m, k, n, relu, 0, 0, 1)
            ms = _abba(names, lambda name: _run(libs[name], case, x, None))
            with full_f32():
                mm = cuda_ms(lambda: x["a"] @ x["w"])
            nbytes = 4 * (m * k + 2 * k * n + m * n) + (4 * m * n if ln
                                                        else 0)
            flops = 2 * m * k * n
            bound = max(nbytes / HBM_BPS, 3 * flops / TF32_FLOPS) * 1e3
            ffma = max(nbytes / HBM_BPS, flops / F32_FLOPS) * 1e3
            _line(f"f32 {geo} {label}", f"[{m},{k},{n}]", count, ms, bound,
                  f"f32 matmul {mm:.3f}, FFMA bound {ffma:.3f}")
            for name, t in ms.items():
                total[name] += count * t
            total["bound"] += count * bound
            total["matmul"] += count * mm
            total["ffma"] += count * ffma
            del x
            torch.cuda.empty_cache()
        print(f"time of one f32 {geo} forward's GEMMs (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in total.items()), flush=True)
        # the stem layer's QKV GEMM, one a forward
        m, k, n = table[0][1:4]
        x = inputs(m, k, n, dtype=torch.float32)
        ms = _abba(names, lambda name: libs[name].qkv(x["a"], x["w"], x["b"]))
        with full_f32():
            mm = cuda_ms(lambda: x["a"] @ x["w"])
        nbytes = 4 * (m * k + k * n + m * n + n)
        bound = max(nbytes / HBM_BPS, 2 * m * k * n / F32_FLOPS) * 1e3
        _line(f"f32 {geo} qkv stem", f"[{m},{k},{n}]", 1, ms, bound,
              f"f32 matmul {mm:.3f}")
        del x
        torch.cuda.empty_cache()


def timing_f32_bwd(libs: dict) -> None:
    """Each variant's f32 dX and dW at every product of PAPER_STEP and
    DEFAULT_STEP, A B .. B A, beside f32 torch.matmul (IEEE: ``dy @ w.t()``;
    ``a.t() @ dy`` and ``dy.sum(0)``), the bound (bytes, or the products as
    3xTF32) and the FFMA bound; and the totals of one step's products. All
    timed by ``graph_ms``: at the default widths a call's host work
    outlasts its kernels."""
    import torch

    from nylon_amt_tpu_torch.ops.precision import full_f32

    names = list(libs)
    f32 = torch.float32
    for geo, table in (("paper", PAPER_STEP), ("default", DEFAULT_STEP)):
        totals = {kind: dict.fromkeys(names + ["bound", "matmul", "ffma"],
                                      0.0) for kind in ("gemm_nt", "wgrad")}
        for label, kind, m, k, n, *rest in table:
            count = rest[-1]
            if kind == "gemm_nt":
                x = bwd_inputs(("nt", m, k, n, *rest[:3]), dtype=f32)
                side = 1 if rest[0] else 0
                ms = _abba(names, lambda name: libs[name].nt(**x), graph_ms)
                with full_f32():
                    mm = graph_ms(lambda: x["dy"] @ x["w"].t())
                nbytes = 4 * (m * k + n * k + m * n * (1 + side))
                shape = f"[{m},{k}->{n}] " + " ".join(
                    v for v, on in ((rest[0], rest[0]), ("m1", rest[1]),
                                    ("m2", rest[2])) if on)
            else:
                x = bwd_inputs(("wg", m, k, n), dtype=f32)
                ms = _abba(names,
                           lambda name: libs[name].wgrad(x["a"], x["dy"]),
                           graph_ms)
                with full_f32():
                    mm = graph_ms(lambda: (x["a"].t() @ x["dy"],
                                           x["dy"].sum(0)))
                nbytes = 4 * (m * k + m * n + k * n + n)
                shape = f"[{m},{k}x{n}]"
            flops = 2 * m * k * n
            bound = max(nbytes / HBM_BPS, 3 * flops / TF32_FLOPS) * 1e3
            ffma = max(nbytes / HBM_BPS, flops / F32_FLOPS) * 1e3
            _line(f"f32 {geo} {kind} {label}", shape, count, ms, bound,
                  f"f32 matmul {mm:.3f}, FFMA bound {ffma:.3f}")
            tot = totals[kind]
            for name, t in ms.items():
                tot[name] += count * t
            tot["bound"] += count * bound
            tot["matmul"] += count * mm
            tot["ffma"] += count * ffma
            del x
            torch.cuda.empty_cache()
        for kind, tot in totals.items():
            c = sum(rest[-1] for _, k_, *rest in table if k_ == kind)
            print(f"time of one f32 {geo} step's {c} {kind} products (ms): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in tot.items()),
                  flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="+", metavar="NAME=CSRC_DIR")
    ap.add_argument("--out", default="build/gemm_ab")
    ap.add_argument("--no-time", action="store_true")
    ap.add_argument("--f32", action="store_true",
                    help="time the float32 forward GEMMs only")
    ap.add_argument("--f32-bwd", action="store_true",
                    help="time the float32 dX and dW GEMMs only")
    ap.add_argument("--q8", action="store_true",
                    help="check and time the int8 GEMMs only")
    ap.add_argument("--attn16", action="store_true",
                    help="check and time the bf16 attention (mha.cu) only")
    ap.add_argument("--attn32", action="store_true",
                    help="check and time the f32 attention (mha_f32.cu) "
                         "only")
    ap.add_argument("--ln-bwd", action="store_true",
                    help="check and time the LayerNorm backward "
                         "(layer_fused_train.cu's ln_bwd_kernel) only")
    ap.add_argument("--q8-cols", action="store_true",
                    help="check and time V's int8 column quantizer "
                         "(layer_fused_q8.cu's quant_cols_kernel) only")
    ap.add_argument("--hash-mask", action="store_true",
                    help="check and time K6's mask kernel (hash_mask.cu) "
                         "only")
    ap.add_argument("--reduce-rows", action="store_true",
                    help="check and time the partial-sum reduction "
                         "(layer_fused_train.cu's reduce_rows_kernel) only")
    ap.add_argument("--same", action="store_true",
                    help="fail unless every variant's forward GEMMs give the "
                         "first variant's bits and SASS")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gemm_ab: no CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    variants = dict(v.split("=", 1) for v in args.variants)
    t0 = time.perf_counter()
    built = build(variants, Path(args.out),
                  Q8_PARTS if args.q8 or args.q8_cols else ATTN16_PARTS
                  if args.attn16 else ATTN32_PARTS if args.attn32 else
                  LN_PARTS if args.ln_bwd or args.reduce_rows else HASH_PARTS
                  if args.hash_mask else tuple(SOURCES))
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    libs = {name: Lib(paths, variants[name])
            for name, paths in built.items() if paths}
    if args.hash_mask or args.reduce_rows:
        ok = check_hash(libs) if args.hash_mask else check_reduce(libs)
        if libs and not args.no_time:
            timing_hash(libs) if args.hash_mask else timing_reduce(libs)
        first = next(iter(libs), None)
        return 0 if len(libs) == len(variants) and ok.get(first) else 1
    if args.ln_bwd or args.q8_cols:
        ok = check_ln(libs) if args.ln_bwd else check_q8_cols(libs)
        if libs and not args.no_time:
            timing_ln(libs) if args.ln_bwd else timing_q8_cols(libs)
        first = next(iter(libs), None)
        return 0 if len(libs) == len(variants) and ok.get(first) else 1
    if args.q8 or args.attn16 or args.attn32:
        part = "attn16" if args.attn16 else "attn32"
        ok = check_q8(libs) if args.q8 else check_attn(libs, part)
        if libs and not args.no_time:
            timing_q8(libs) if args.q8 else timing_attn(libs, part)
        first = next(iter(libs), None)
        return 0 if len(libs) == len(variants) and ok.get(first) else 1
    ok, ran, differ = check(libs)
    ok32 = check_f32(libs)
    ok32b = check_f32_bwd(libs)
    same = True
    if args.same and len(libs) > 1:
        code = sass({name: built[name] for name in libs})
        first = next(iter(code))
        for name, funcs in code.items():
            if name == first:
                continue
            alike = sum(funcs.get(k) == v for k, v in code[first].items())
            same &= (alike == len(code[first]) == len(funcs)
                     and not differ[name])
            print(f"same {name}: SASS of the bf16 forward GEMMs, the TF32 "
                  f"forward GEMMs and the bf16 and f32 "
                  f"attention identical to {first}'s "
                  f"in {alike} of {len(code[first])} instantiations; bf16 "
                  f"forward outputs differ in {differ[name]} of "
                  f"{len(CHECKS)} cases", flush=True)
            for k, v in code[first].items():
                w = funcs.get(k, [])
                if w != v:
                    i = next((i for i, (x, y) in enumerate(zip(v, w))
                              if x != y), min(len(v), len(w)))
                    print(f"same {name}: {k[:60]}: {len(v)} vs {len(w)} "
                          f"lines, first difference at line {i}: "
                          f"{v[i] if i < len(v) else ''!r} vs "
                          f"{w[i] if i < len(w) else ''!r}", flush=True)
    # every variant that ran is timed; the first (the one under test) must
    # also pass the gates (a reference, e.g. the parent's kernels, is held
    # to them and reported)
    good = {name: lib for name, lib in libs.items() if ran[name]}
    if good and not args.no_time:
        if not args.f32_bwd:
            timing_f32(good)
        if not args.f32:
            timing_f32_bwd(good)
        if not (args.f32 or args.f32_bwd):
            timing(good)
    first = next(iter(libs), None)
    first_ok = first is not None and ok[first] and ok32[first] \
        and ok32b[first]
    return 0 if len(good) == len(variants) and first_ok and same else 1


if __name__ == "__main__":
    sys.exit(main())
