"""nylon_amt_tpu_torch: the PyTorch / CUDA port of ``nylon_amt_tpu``.

Same pipeline as the JAX package (WAV -> log-mel -> hFT transformer ->
posteriors -> notes -> MIDI), with the same module layout and names, written
in PyTorch for an NVIDIA H100. Every Pallas kernel on the ported path is a
hand-written CUDA kernel (``csrc/``, built and loaded by :mod:`.kernels`);
each kernel's plain PyTorch version sits beside it and runs on CPU tensors.

The port keeps its own copies of the JAX package's framework-neutral
modules (configuration, MIDI, the native decoder, the corpus arrays and the
reference key table), so nothing in this package imports JAX or any module
of ``nylon_amt_tpu``.
"""

from nylon_amt_tpu_torch.config import (
    Config,
    FeatureConfig,
    InputConfig,
    MidiConfig,
    ModelConfig,
    TrainConfig,
)
from nylon_amt_tpu_torch.midi.smf import MidiFile, write_notes

__version__ = "0.1.0"

__all__ = ["Config", "FeatureConfig", "InputConfig", "MidiConfig",
           "MidiFile", "ModelConfig", "TrainConfig", "write_notes", "__version__"]
