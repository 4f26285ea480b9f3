"""Build, load and call the port's hand-written CUDA kernels.

The sources in ``csrc/`` are compiled on first use by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per ``.cu`` file, all started together, then
linked into one shared library with a plain C interface, under
``build/cuda/<hash of the sources and flags>/`` at the root of the checkout,
and loaded with :mod:`ctypes`. A missing ``nvcc`` or a failed build raises
with the compiler's output: there is no fallback.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`call` raises when that is not 0. An entry
point that takes activations in the compute dtype exists for bfloat16 and,
under the same name with ``_f32``, for float32 (the default model
configuration computes in float32); :func:`entry` picks one by dtype and
raises on any other.

``launches`` counts, per public kernel wrapper, the calls that launched the
kernel on the card (the plain CPU versions never count). A run that must go
through the kernels resets the counts, runs, and reads them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "cuda"
LIB_NAME = "libnylon_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# One counter per public wrapper: K1 log_mel, K2 encoder_layer_with_stem,
# K3 encoder_layer, K4 decoder_layer_zero, K5 decoder_layer; K6
# hash_keep_mask (its standalone kernel: the embedding-dropout site, or a
# written mask), and the forward and backward of K7 encoder_layer_train, K8
# decoder_layer_zero_train and K9 decoder_layer_train; K10 fused_mha, K11
# fused_mha_with_probs and K12 fused_mha_dropout, forward and backward (the
# per-site attention); K13, the int8 (W8A8) twins of K2-K5. A launch in
# float32 counts as one in bfloat16 does. And, inside those layers, the two
# float32 forward GEMM kernels (3xTF32 wgmma, csrc/layer_fused_f32.cu), the
# stem layer's float32 QKV GEMM on the CUDA cores, the training
# backward's float32 dX and dW GEMMs (3xTF32 wgmma), and its LayerNorm
# backward (ln_bwd_kernel, bf16 and f32 alike), one count a launch.
launches: dict[str, int] = {"log_mel": 0, "encoder_layer_with_stem": 0,
                            "encoder_layer": 0, "decoder_layer_zero": 0,
                            "decoder_layer": 0, "hash_keep_mask": 0,
                            "encoder_layer_train": 0,
                            "encoder_layer_train_bwd": 0,
                            "decoder_layer_zero_train": 0,
                            "decoder_layer_zero_train_bwd": 0,
                            "decoder_layer_train": 0,
                            "decoder_layer_train_bwd": 0,
                            "fused_mha": 0, "fused_mha_bwd": 0,
                            "fused_mha_with_probs": 0,
                            "fused_mha_with_probs_bwd": 0,
                            "fused_mha_dropout": 0,
                            "fused_mha_dropout_bwd": 0,
                            "encoder_layer_with_stem_q8": 0,
                            "encoder_layer_q8": 0,
                            "decoder_layer_zero_q8": 0,
                            "decoder_layer_q8": 0,
                            "gemm_bias_f32": 0, "gemm_res_ln_f32": 0,
                            "gemm_bias_ffma_f32": 0, "gemm_nt_f32": 0,
                            "wgrad_f32": 0, "ln_bwd": 0}

_P, _I, _L, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float, ctypes.c_uint
_SITE = [_U, _U, _F, _I]  # a dropout site: key, thresh, scale, half
_SIGNATURES = {
    # wav, n, bases, n_cols, groups, n_groups, mel_tab, mel_w, out, n_frames,
    # n_fft, hop, n_mels, log_offset, stream
    "nylon_log_mel": [_P, _I, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _F,
                      _P],
    # spec_t, keff, beff, pos, out, batch, total, n_bin, n_frame, n_proc,
    # hid, sqrt_hid, stream
    "nylon_stem_embed": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # a, w, bias, out, M, N, K, relu, stream
    "nylon_gemm_bias": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # a, w, bias, res, gamma, beta, out, M, N, K, eps, stream
    "nylon_gemm_res_ln": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    # q, k, v, o, n_seq, lq, lk, n_heads, head_dim, q_row, q_seq, kv_row,
    # kv_seq, scale_log2e, stream
    "nylon_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L,
                        _F, _P],
    # q, k, v, o, probs, n_seq, lq, lk, n_heads, head_dim, q_row, q_seq,
    # kv_row, kv_seq, scale_log2e, stream
    "nylon_attention_probs": [_P] * 5 + [_I] * 5 + [_L] * 4 + [_F, _P],
    # x, out, rows, d2, key, thresh, scale, half, base, dtype_bf16, stream
    "nylon_hash_mask": [_P, _P, _L, _I, _U, _U, _F, _I, _U, _I, _P],
    # a, w, bias, out, M, N, K, relu, site, stream
    "nylon_gemm_bias_drop": [_P, _P, _P, _P, _I, _I, _I, _I, *_SITE, _P],
    # a, w, bias, res, gamma, beta, out, pre_out, M, N, K, eps, active,
    # site, stream
    "nylon_gemm_res_ln_train": [_P] * 8 + [_I, _I, _I, _F, _I, *_SITE, _P],
    # q, k, v, o, n_seq, lq, lk, n_heads, head_dim, q_row, q_seq, kv_row,
    # kv_seq, scale_log2e, seed_mix, head_tag0, thresh, scale, half, stream
    "nylon_attention_drop": [_P] * 4 + [_I] * 5 + [_L] * 4
    + [_F, _U, _I, _U, _F, _I, _P],
    # dy, s, gamma, da, dam, dg_part, db_part, M, N, rows_per_tile,
    # n_blocks, eps, active, site, stream
    "nylon_ln_bwd": [_P] * 7 + [_I, _I, _I, _I, _F, _I, *_SITE, _P],
    # dy, w, out, gate, addend, M, N, Kout, act1, site1, act2, site2, stream
    "nylon_gemm_nt": [_P] * 5 + [_I, _I, _I, _I, *_SITE, _I, *_SITE, _P],
    # a, dy, part, bias_part, M, Ka, N, rows_per_chunk, chunks, stream
    "nylon_wgrad": [_P] * 4 + [_I] * 5 + [_P],
    # parts, out, P, n, stream
    "nylon_reduce_rows": [_P, _P, _I, _L, _P],
    # q, k, v, dout, dq, dk, dv, n_seq, lq, lk, n_heads, head_dim, q_row,
    # kv_row, do_row, dq_row, dkv_row, scale, scale_log2e, active, seed_mix,
    # head_tag0, thresh, pscale, half, stream
    "nylon_attention_bwd": [_P] * 7 + [_I] * 5 + [_L] * 5
    + [_F, _F, _I, _U, _I, _U, _F, _I, _P],
    # head_dim, lq, lk, bwd -> resident blocks per SM of the f32 attention
    "nylon_attention_f32_occupancy": [_I, _I, _I, _I],
    # x, ld_x, M, K, q, s, stream
    "nylon_q8_quant_rows": [_P, _L, _I, _I, _P, _P, _P],
    # x, ld_x, n_seq, L, hid, vt, sv, stream
    "nylon_q8_quant_cols": [_P, _L, _I, _I, _I, _P, _P, _P],
    # a [M, K], sa, wt (the weight codes K-major, W^T [N, K]), sw, bias,
    # out, q (the codes of the first n_seg column segments of seg columns;
    # null: none), s (their scales), M, N, K, relu, seg, n_seg, stream
    "nylon_q8_gemm_bias": [_P] * 8 + [_I] * 6 + [_P],
    # a, sa, wt, sw, bias, res, gamma, beta, out, q_out, s_out, M, N, K,
    # eps, stream
    "nylon_q8_gemm_res_ln": [_P] * 11 + [_I] * 3 + [_F, _P],
    # q, q_row, sq, k, k_row, sk, vt, vt_ld, sv, codes, scales, o (null:
    # not written), n_seq, lq, lk, n_heads, head_dim, scale_log2e, stream
    "nylon_q8_attention": [_P, _L, _P, _P, _L, _P, _P, _I, _P, _P, _P, _P]
    + [_I] * 5 + [_F, _P],
}

# The entry points with a float32 twin ("<name>_f32", the same arguments).
_F32_TWINS = ("nylon_stem_embed", "nylon_attention", "nylon_attention_probs",
              "nylon_attention_drop", "nylon_ln_bwd",
              "nylon_attention_bwd", "nylon_q8_quant_rows",
              "nylon_q8_quant_cols", "nylon_q8_gemm_bias",
              "nylon_q8_gemm_res_ln", "nylon_q8_attention")
_SIGNATURES.update({f"{n}_f32": _SIGNATURES[n] for n in _F32_TWINS})
# The float32 forward GEMMs: the bf16 arguments with the weight as its TF32
# pair, two pointers (w_big, w_small [N, K]: ops/layer_fused.py::tf32_pair)
_SIGNATURES.update({f"{n}_f32": [_P, _P, *_SIGNATURES[n][1:]] for n in (
    "nylon_gemm_bias", "nylon_gemm_bias_drop", "nylon_gemm_res_ln",
    "nylon_gemm_res_ln_train")})
# the float32 dX GEMM: dy, then the weight [Kout, N] as its TF32 pair (w_big,
# w_small [Kout, N]: pack_tf32's dX pair), then nylon_gemm_nt's arguments
_SIGNATURES["nylon_gemm_nt_f32"] = [_P, _P, *_SIGNATURES["nylon_gemm_nt"][1:]]
# the float32 dW GEMM: nylon_wgrad's arguments and, before the stream, the
# dW tile's rows and columns (ops/layer_fused_train.py::wgrad_tile)
_SIGNATURES["nylon_wgrad_f32"] = [_P] * 4 + [_I] * 7 + [_P]
# the float32 GEMM + bias on the CUDA cores (the stem layer's QKV): a, w [K,
# N], bias, out, M, N, K, relu, stream
_SIGNATURES["nylon_gemm_bias_ffma_f32"] = _SIGNATURES["nylon_gemm_bias"]
# the float32 attention backward with its scores on FFMA (the layer that the
# stem feeds): nylon_attention_bwd_f32's arguments
_SIGNATURES["nylon_attention_bwd_ffma_f32"] = _SIGNATURES[
    "nylon_attention_bwd"]
# the float32 attention forward with its scores on FFMA (the layer that the
# stem feeds): nylon_attention_drop_f32's arguments with `active` (0: no
# dropout) before seed_mix
_SIGNATURES["nylon_attention_ffma_f32"] = [_P] * 4 + [_I] * 5 + [_L] * 4 \
    + [_F, _I, _U, _I, _U, _F, _I, _P]

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def sources() -> list[Path]:
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def find_nvcc() -> str | None:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    return None


def build() -> Path:
    """Compile ``csrc/*.cu`` into the library (if not built yet); returns its
    path. Each source compiles in its own ``nvcc`` process, all at once;
    ``build.log`` beside the library keeps every ``ptxas -v`` register and
    shared-memory report."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "CUDA kernels of nylon_amt_tpu_torch cannot be built")
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    srcs = [p for p in sources() if p.suffix == ".cu"]
    objs = [out_dir / f"{p.stem}.{tag}.o" for p in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(p)]
            for p, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    log = "".join(f"$ {' '.join(c)}\n{o}" for c, o in zip(cmds, outs))
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    rc = next((proc.returncode for proc in procs if proc.returncode), 0)
    if rc == 0:
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        log += f"$ {' '.join(link)}\n{proc.stdout}{proc.stderr}"
        rc = proc.returncode
    (out_dir / "build.log").write_text(log)
    for o in objs:
        o.unlink(missing_ok=True)
    if rc != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {rc}:\n{log}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first use. Raises if it cannot be built
    or loaded; never returns None."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.nylon_error_string.argtypes = [ctypes.c_int]
        lib.nylon_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def call(name: str, *args) -> None:
    """Launch C entry point ``name``; raise on a non-zero CUDA status."""
    lib = load()
    status = getattr(lib, name)(*args)
    if status != 0:
        msg = lib.nylon_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")


def stream_of(t) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s
    device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check_dtype(name: str, dtype) -> None:
    """Raise unless the kernels take activations of ``dtype``: bfloat16 or
    float32."""
    import torch

    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: the kernels take bfloat16 or float32, "
                         f"got {dtype}")


def entry(name: str, dtype) -> str:
    """The C entry point ``name`` for activations of ``dtype``: itself for
    bfloat16, its ``_f32`` twin for float32; any other dtype raises."""
    import torch

    check_dtype(name, dtype)
    return name if dtype == torch.bfloat16 else f"{name}_f32"


def check_cuda(name: str, t, dtype, ndim: int | None = None) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on a CUDA device
    whose data pointer is 16-byte aligned (the kernels load 16 bytes at a
    time)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor, got strides "
                         f"{t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
