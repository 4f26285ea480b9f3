"""Build + load the native decoder shared library.

A copy of ``nylon_amt_tpu/native/build.py`` for the port. The library is
built from ``decoder.cpp`` beside this file into ``$NYLON_NATIVE_CACHE``
or, without it, into ``build/native/`` at the root of the checkout.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

_lock = threading.Lock()
_lib = None
_tried = False

# Shipped as package data so pip-installed trees can rebuild the library.
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "decoder.cpp")


def _lib_path() -> str:
    cache = os.environ.get("NYLON_NATIVE_CACHE") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "build", "native")
    return os.path.join(cache, "libnylon_decoder.so")


def build(force: bool = False) -> str | None:
    """Compile decoder.cpp -> cached .so; returns the path or None.

    g++ writes a file of its own in the cache directory, which then
    replaces the library in one ``os.replace``: processes that build at
    once each install a whole library, and none can load a half-written
    one."""
    out = _lib_path()
    if os.path.exists(out) and not force:
        return out
    if not os.path.exists(_SRC):
        return None
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    except (subprocess.SubprocessError, FileNotFoundError, OSError) as e:
        print(f"nylon_amt_tpu_torch: native decoder build failed ({e}); "
              "using Python fallback", file=sys.stderr)
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load_decoder_library():
    """ctypes handle to the decoder library, or None (Python fallback)."""
    global _lib, _tried
    if os.environ.get("NYLON_NATIVE", "1") == "0":
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            # a library left by an interrupted build: rebuild once
            path = build(force=True)
            if path is None:
                return None
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                return None
        fn = lib.nylon_decode_notes
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_float),   # onset
            ctypes.POINTER(ctypes.c_float),   # offset
            ctypes.POINTER(ctypes.c_float),   # mpe
            ctypes.POINTER(ctypes.c_int8),    # velocity
            ctypes.c_int, ctypes.c_int,       # T, P
            ctypes.c_float, ctypes.c_float, ctypes.c_float,  # thresholds
            ctypes.c_int, ctypes.c_int,       # mode_offset, ignore_zero
            ctypes.c_double, ctypes.c_int,    # hop_sec, note_min
            ctypes.c_int,                     # cap
            ctypes.POINTER(ctypes.c_int),     # out_pitch
            ctypes.POINTER(ctypes.c_double),  # out_onset
            ctypes.POINTER(ctypes.c_double),  # out_offset
            ctypes.POINTER(ctypes.c_int),     # out_velocity
        ]
        _lib = lib
        return _lib


if __name__ == "__main__":
    path = build(force="--force" in sys.argv)
    print(path or "build failed")
