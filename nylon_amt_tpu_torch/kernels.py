"""Build, load and call the port's hand-written CUDA kernels.

The sources in ``csrc/`` are compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, under
``build/cuda/<hash of the sources and flags>/`` at the root of the checkout,
and loaded with :mod:`ctypes`. A missing ``nvcc`` or a failed build raises
with the compiler's output: there is no fallback.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`call` raises when that is not 0.

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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# One counter per public wrapper: K1 log_mel, K2 encoder_layer_with_stem,
# K3 encoder_layer, K4 decoder_layer_zero, K5 decoder_layer.
launches: dict[str, int] = {"log_mel": 0, "encoder_layer_with_stem": 0,
                            "encoder_layer": 0, "decoder_layer_zero": 0,
                            "decoder_layer": 0}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_SIGNATURES = {
    # wav, n, wc_t, ws_t, fb, out, n_frames, n_fft, hop, n_freq_pad, n_mels,
    # log_offset, stream
    "nylon_log_mel": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
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
}

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
    path. ``build.log`` beside it keeps ``ptxas -v``'s register and shared
    memory report."""
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
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *(str(p) for p in sources() if p.suffix == ".cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    (out_dir / "build.log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{log}")
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
