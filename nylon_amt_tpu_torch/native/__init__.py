"""Native (C++) runtime components of the port, loaded via ctypes.

A copy of ``nylon_amt_tpu/native``: the peak-picking note decoder
(``native/decoder.cpp``), built on demand with the system g++ and cached.
Consumers fall back to the pure-Python implementation when the toolchain or
binary is unavailable. Set ``NYLON_NATIVE=0`` to force the Python paths.
"""

from nylon_amt_tpu_torch.native.build import load_decoder_library

__all__ = ["load_decoder_library"]
