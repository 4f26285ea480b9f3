"""Batched sliding-window transcription (PyTorch).

Port of :mod:`nylon_amt_tpu.infer.transcribe` with the reference's padding
geometry and output shapes (``model/amt.py:66-176``):

* plain mode: pad ``margin_b`` before; round frames up to a multiple of
  ``num_frame`` and pad ``margin_f`` after, all with ``min_value``; outputs
  have ``ceil(T / num_frame) * num_frame`` frames;
* stride mode: hop ``num_frame / 2``, keep the centred
  ``[n_offset, n_offset + num_frame / 2)`` slice of every window.

Windows run through :func:`nylon_amt_tpu_torch.infer.engine.forward` in
fixed-size batches (the last one padded by repeating its last window). On a
CUDA device every layer launches the port's kernels; on the CPU the same
engine runs the plain versions. Onset/offset/mpe posteriors are sigmoids of
the logits and velocity is the argmax over the 128 classes (int8); each
batch's posteriors come back to the host in one copy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nylon_amt_tpu.config import Config
from nylon_amt_tpu.midi.smf import write_notes
from nylon_amt_tpu_torch.infer import engine
from nylon_amt_tpu_torch.infer.decode import mpe2note
from nylon_amt_tpu_torch.models.hft import HFT, supports
from nylon_amt_tpu_torch.ops.mel import MelFrontend
from nylon_amt_tpu_torch.utils.wavio import load_mono

_POST_KEYS = ("onset", "offset", "mpe", "velocity")


class Transcriber:
    """Feature extraction + windowed transcription on ``device`` (mirrors
    the reference ``AMT`` class, ``amt.py:9-31``). ``model`` is an
    :class:`HFT` whose weights already live on ``device``."""

    def __init__(self, config: Config, model: HFT,
                 device: torch.device | str, batch_windows: int = 8):
        if not supports(config):
            raise ValueError("nylon_amt_tpu_torch does not port this "
                             f"architecture: {config.model}")
        self.config = config
        self.device = torch.device(device)
        if self.device.type != "cpu" and model.dtype != torch.bfloat16:
            raise ValueError("the CUDA layer kernels compute in bfloat16: "
                             "set model.compute_dtype to 'bfloat16', or run "
                             "on the CPU")
        self.model = model
        self.batch_windows = batch_windows
        # Stage-1-only models ("cafreq" decoder) emit only A heads.
        self.families = (("A", "B") if config.model.dec_alg == "cafreq_satime"
                         else ("A",))
        self.frontend = MelFrontend(config.feature, self.device)
        self.packed = engine.pack_params(model, model.dtype)

    # -- features ------------------------------------------------------------

    def wav2feature(self, path: str) -> np.ndarray:
        """WAV -> log-mel ``[n_frames, n_bins]`` (reference ``amt.py:34-63``)."""
        wav = load_mono(path, self.config.feature.sr)
        return self.frontend(wav).cpu().numpy()

    # -- transcription ---------------------------------------------------------

    def _run_batch(self, windows: torch.Tensor) -> torch.Tensor:
        """windows ``[N, n_bins, window_frames]`` -> posteriors stacked as
        one float32 tensor ``[n_keys, N, num_frame, num_note]`` (velocity
        classes as exact small integers), in :meth:`_post_keys` order."""
        out = engine.forward(self.packed, windows, self.config)
        posts = []
        for fam in self.families:
            for key in _POST_KEYS[:3]:
                posts.append(torch.sigmoid(out[f"{key}_{fam}"]).float())
            posts.append(out[f"velocity_{fam}"].argmax(-1).float())
        return torch.stack(posts)

    def _post_keys(self) -> list[str]:
        return [f"{k}_{f}" for f in self.families for k in _POST_KEYS]

    def _windows(self, feature: np.ndarray, starts: np.ndarray) -> np.ndarray:
        idx = starts[:, None] + np.arange(self.config.window_frames)
        return feature[idx].transpose(0, 2, 1)  # [N, n_bins, window]

    def _run_all(self, windows: np.ndarray) -> dict[str, np.ndarray]:
        """Run N windows through the engine in fixed-size batches; every
        batch's posteriors come back in one device-to-host copy (into pinned
        memory on CUDA, collected after the last batch is queued)."""
        N = windows.shape[0]
        bw = self.batch_windows
        pin = self.device.type == "cuda"
        pending = []
        for i in range(0, N, bw):
            chunk = windows[i: i + bw]
            n = chunk.shape[0]
            if n < bw:  # pad to the fixed batch; extra rows dropped below
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], bw - n, axis=0)])
            batch = torch.from_numpy(np.ascontiguousarray(chunk)).to(
                self.device)
            post = self._run_batch(batch)
            host = torch.empty(post.shape, dtype=post.dtype, pin_memory=pin)
            host.copy_(post, non_blocking=pin)
            pending.append((n, host))
        if pin:
            torch.cuda.synchronize(self.device)
        keys = self._post_keys()
        stacked = np.concatenate([h[:, :n].numpy() for n, h in pending],
                                 axis=1)
        result = {k: stacked[i] for i, k in enumerate(keys)}
        for k in keys:
            if k.startswith("velocity"):
                result[k] = result[k].astype(np.int8)
        return result

    def transcript(self, feature: np.ndarray, mode: str = "combination"
                   ) -> dict[str, np.ndarray]:
        """Full-piece transcription, plain hops (reference ``amt.py:66-118``):
        ``{onset_A, offset_A, mpe_A, velocity_A[, *_B]}`` arrays of shape
        ``[ceil(T/num_frame)*num_frame, num_note]``."""
        cfg = self.config
        inp = cfg.input
        T = feature.shape[0]
        len_s = math.ceil(T / inp.num_frame) * inp.num_frame - T
        pad_val = np.float32(inp.min_value)
        padded = np.concatenate([
            np.full((inp.margin_b, cfg.feature.n_bins), pad_val),
            np.asarray(feature, np.float32),
            np.full((len_s + inp.margin_f, cfg.feature.n_bins), pad_val),
        ])
        starts = np.arange(0, T, inp.num_frame)
        post = self._run_all(self._windows(padded, starts))
        fams = ("A", "B") if mode == "combination" else ("A",)
        return {f"{key}_{fam}": post[f"{key}_{fam}"].reshape(
                    -1, cfg.midi.num_note)
                for fam in fams for key in _POST_KEYS}

    def transcript_stride(self, feature: np.ndarray, n_offset: int,
                          mode: str = "combination") -> dict[str, np.ndarray]:
        """Half-window-hop overlap transcription with centre crop
        (reference ``amt.py:121-176``)."""
        cfg = self.config
        inp = cfg.input
        half = inp.num_frame // 2
        T = feature.shape[0]
        tmp_len = T + inp.margin_b + inp.margin_f + half
        len_s = math.ceil(tmp_len / half) * half - tmp_len
        pad_val = np.float32(inp.min_value)
        padded = np.concatenate([
            np.full((inp.margin_b + n_offset, cfg.feature.n_bins), pad_val),
            np.asarray(feature, np.float32),
            np.full((len_s + inp.margin_f + (half - n_offset),
                     cfg.feature.n_bins), pad_val),
        ])
        starts = np.arange(0, T, half)
        post = self._run_all(self._windows(padded, starts))
        fams = ("A", "B") if mode == "combination" else ("A",)
        return {f"{key}_{fam}": post[f"{key}_{fam}"][
                    :, n_offset: n_offset + half, :].reshape(
                    -1, cfg.midi.num_note)[: T + len_s]
                for fam in fams for key in _POST_KEYS}

    # -- decode + emit ---------------------------------------------------------

    def mpe2note(self, *args, **kwargs) -> list[dict]:
        return mpe2note(self.config, *args, **kwargs)

    def note2midi(self, notes: list[dict], path: str) -> None:
        write_notes(path, notes)
