"""Streaming (serving) benchmark of the port: real-time factor and block
latency.

The counterpart of ``scripts/bench_stream.py``. It drives
:class:`~nylon_amt_tpu_torch.infer.stream.StreamingTranscriber` on the
paper-scale model (hid 256, pf 512, 3 + 3 layers, 4 heads, bf16; random
weights from a seed) as ``cli serve`` does: audio fed in fixed chunks,
posterior blocks emitted as soon as their future margin exists. It prints
one JSON line:

* ``rtf``: audio seconds per wall second over the whole stream (batch 1);
* ``block_ms_p50`` / ``block_ms_p95``: host-clock wall time of the feeds
  that emit a block (K1 on the segment, the forward, the copy back and the
  ring-buffer bookkeeping);
* ``algorithmic_latency_s``: the emit delay of the model's geometry (block
  + future margin + STFT lookahead), whatever the compute.

With ``--streams N`` (N > 1) the N streams run as sessions of one
:class:`~nylon_amt_tpu_torch.infer.serve.StreamServer` (``max_batch`` N),
fed interleaved; ``rtf`` is then the aggregate (N x audio seconds per wall
second), ``pump_ms_p50`` / ``pump_ms_p95`` the wall time of the pumps that
ran blocks and ``windows_per_s`` the windows forwarded per wall second.
The notes are decoded after the timed loop (random weights decode absurd
note counts, a property of the weights and not of the pipeline); the
server's pumps decode with thresholds of 0.9 for the same reason.

Run on the card from the root of a checkout::

    python -m nylon_amt_tpu_torch.tools.stream_bench --streams 1
    python -m nylon_amt_tpu_torch.tools.stream_bench --streams 8

The JSON line names the card and its power limit (``nvidia-smi``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch


def _card(device: torch.device) -> str:
    if device.type != "cuda":
        return str(device)
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def _audio(seconds: float, sr: int) -> np.ndarray:
    """A gated 440 Hz tone over a noise floor (``scripts/bench_stream.py``'s
    signal)."""
    rng = np.random.default_rng(0)
    t = np.arange(int(seconds * sr)) / sr
    return (0.2 * np.sin(2 * np.pi * 440.0 * t)
            * (np.sin(2 * np.pi * 0.7 * t) > 0)
            + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pct(ms: list[float], q: float) -> float:
    ms = sorted(ms)
    return ms[min(len(ms) - 1, int(len(ms) * q))] if ms else float("nan")


def bench_single(config, model, device, wav, chunk: int) -> dict:
    from nylon_amt_tpu_torch.infer.stream import StreamingTranscriber
    from nylon_amt_tpu_torch.infer.transcribe import Transcriber

    tr = Transcriber(config, model, device, batch_windows=1)
    warm = StreamingTranscriber(config, transcriber=tr)
    for i in range(0, min(wav.shape[0], chunk * 60), chunk):
        warm.feed(wav[i: i + chunk])
    warm.flush()
    st = StreamingTranscriber(config, transcriber=tr)
    block_ms = []
    _sync(device)
    t0 = time.perf_counter()
    for i in range(0, wav.shape[0], chunk):
        tb = time.perf_counter()
        if st.feed(wav[i: i + chunk]):   # posteriors are on the host
            block_ms.append((time.perf_counter() - tb) * 1e3)
    st.flush()
    _sync(device)
    wall = time.perf_counter() - t0
    return {"rtf": wav.shape[0] / config.feature.sr / wall,
            "blocks": len(block_ms), "block_paths": st.paths,
            "block_ms_p50": _pct(block_ms, 0.5),
            "block_ms_p95": _pct(block_ms, 0.95),
            "algorithmic_latency_s": st.latency_seconds,
            "notes": len(st.notes())}


def bench_multi(config, model, device, wav, chunk: int, n: int) -> dict:
    from nylon_amt_tpu_torch.infer.serve import StreamServer
    from nylon_amt_tpu_torch.infer.transcribe import Transcriber

    tr = Transcriber(config, model, device, batch_windows=n)
    wavs = [np.roll(wav, 1000 * i) for i in range(n)]   # other content
    dk = dict(thred_onset=0.9, thred_offset=0.9, thred_mpe=0.9)

    def run(seconds: float | None) -> tuple[list[float], int, float, float]:
        srv = StreamServer(config, transcriber=tr)
        sids = [srv.open() for _ in range(n)]
        end = wav.shape[0] if seconds is None else int(
            seconds * config.feature.sr)
        pump_ms, windows = [], 0

        def emitted() -> int:
            return sum(srv.session(s).frames_emitted for s in sids)

        _sync(device)
        t0 = time.perf_counter()
        for i in range(0, end, chunk):
            for sid, w in zip(sids, wavs):
                srv.feed(sid, w[i: i + chunk])
            before = emitted()
            tb = time.perf_counter()
            srv.pump(**dk)
            dt = (time.perf_counter() - tb) * 1e3
            if emitted() > before:       # the pumps that ran blocks
                pump_ms.append(dt)
                windows += (emitted() - before) // config.input.num_frame
        _sync(device)
        wall = time.perf_counter() - t0   # the live loop; the drain is not
        for sid in sids:
            srv.close(sid)
        while srv.session_ids:
            srv.pump(**dk)
        return pump_ms, windows, wall, end / config.feature.sr

    run(6.5)                               # warm-up
    pump_ms, windows, wall, seconds = run(None)
    return {"rtf": n * seconds / wall, "streams": n,
            "pump_ms_p50": _pct(pump_ms, 0.5),
            "pump_ms_p95": _pct(pump_ms, 0.95),
            "pumps_with_blocks": len(pump_ms), "windows": windows,
            "windows_per_s": windows / wall,
            "algorithmic_latency_s": None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--chunk-ms", type=float, default=100.0)
    ap.add_argument("--streams", type=int, default=1,
                    help=">1: concurrent sessions through one StreamServer")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from nylon_amt_tpu_torch import Config, ModelConfig
    from nylon_amt_tpu_torch.models.hft import HFT
    from nylon_amt_tpu_torch.models.init import reference_initialize

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("stream_bench: --device cuda, but no CUDA card")
    config = Config(model=dataclasses.replace(
        ModelConfig.paper_scale(), dropout=0.0, compute_dtype="bfloat16"))
    model = reference_initialize(HFT(config, device),
                                 torch.Generator().manual_seed(0))
    model.eval()
    wav = _audio(args.seconds, config.feature.sr)
    chunk = max(1, int(config.feature.sr * args.chunk_ms / 1000))
    if args.streams > 1:
        res = bench_multi(config, model, device, wav, chunk, args.streams)
    else:
        res = bench_single(config, model, device, wav, chunk)
    print(json.dumps({"metric": "stream_rtf", **res,
                      "seconds": args.seconds, "chunk_ms": args.chunk_ms,
                      "device": _card(device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
