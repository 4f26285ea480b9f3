"""nylon_amt_tpu_torch: the PyTorch / CUDA port of ``nylon_amt_tpu``.

Same pipeline as the JAX package (WAV -> log-mel -> hFT transformer ->
posteriors -> notes -> MIDI), with the same module layout and names, written
in PyTorch for an NVIDIA H100. Every Pallas kernel on the ported path is a
hand-written CUDA kernel (``csrc/``, built and loaded by :mod:`.kernels`);
each kernel's plain PyTorch version sits beside it and runs on CPU tensors.

The framework-neutral configuration and MIDI modules of the JAX package are
shared, not copied; they are re-exported here. Nothing in this package
imports JAX.
"""

from nylon_amt_tpu.config import (
    Config,
    FeatureConfig,
    InputConfig,
    MidiConfig,
    ModelConfig,
)
from nylon_amt_tpu.midi.smf import MidiFile, write_notes

__version__ = "0.1.0"

__all__ = ["Config", "FeatureConfig", "InputConfig", "MidiConfig",
           "MidiFile", "ModelConfig", "write_notes", "__version__"]
