"""Drive the PyTorch / CUDA port on one GPU, end to end.

Run from the root of a checkout on a machine with a CUDA card:

    python chip_smoke.py

Phases (each prints one line; any failed check raises, so the script exits
non-zero and never prints the last line):

(a) build the kernels of ``nylon_amt_tpu_torch/csrc`` with nvcc (sm_90a);
(b) K1, the log-mel kernel, within atol 2e-4 of a float64 truth on 120 s of
    seeded audio and on a quiet variant of it (see the check), and the
    kernel's and the plain version's times;
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
(f) the launch counts of run (d): every kernel of the path ran.

PyTorch's global TF32 flags stay at their defaults: the port's own guards
keep its f32 paths in IEEE f32, and the script wraps only its own f32
references in ``full_f32``.

Before the last line it prints the card's name and power limit and one JSON
object with each kernel's launches, error and times. The last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
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


def profile_forward(fwd, iters: int = 10) -> None:
    """Device time per kernel over ``iters`` forwards, by torch.profiler,
    and the device-busy share of the profiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
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
    log(f"(e) profile, {iters} forwards: {wall:.3f} ms wall per forward, "
        f"{busy:.3f} ms device-busy ({busy / wall:.1%})")
    for name, ms, calls in rows[:12]:
        log(f"(e)   {name[:64]:<64} {ms:8.3f} ms {ms / busy:6.1%} x{calls}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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

    # (b) K1 log-mel ------------------------------------------------------------
    # The f32 DFT of the lowest mel bins of zero-mean audio is a sum with
    # heavy cancellation: there, any two f32 summation orders (the kernel's
    # and cuBLAS's) differ by more than 2e-4 in log-mel. So the kernel is
    # held within 2e-4 of a float64 truth, on the smoke's audio and on a
    # quiet variant (noise floor 0.01), where the cancellation is worst.
    cfg = Config(model=dataclasses.replace(ModelConfig.paper_scale(),
                                           compute_dtype="bfloat16"))
    fe = MelFrontend(cfg.feature, dev)
    audio = synth_audio(AUDIO_SEC, rng)
    quiet = synth_audio(AUDIO_SEC, np.random.default_rng(SEED + 1), 0.01)
    k1 = {}
    for label, samples in (("main", audio), ("quiet", quiet)):
        w = torch.from_numpy(samples).to(dev)
        got = log_mel(w, fe)
        ref = log_mel_plain(w, fe)
        frames = fe.frame(w).double()
        re, im = frames @ fe.cos_w.double().T, frames @ fe.sin_w.double().T
        ref64 = torch.log((re * re + im * im) @ fe.fb.double()
                          + cfg.feature.log_offset)
        del frames, re, im
        err64 = (got.double() - ref64).abs().max().item()
        k1[label] = dict(
            err64=err64, plain_err64=(ref.double() - ref64).abs().max().item(),
            diff=(got - ref).abs().max().item())
        if got.shape != ref64.shape or not err64 <= K1_ATOL:
            raise AssertionError(f"K1 log_mel ({label} audio): shape "
                                 f"{tuple(got.shape)} vs {tuple(ref.shape)}, "
                                 f"{err64} from float64 (atol {K1_ATOL})")
    wav = torch.from_numpy(audio).to(dev)
    ms = cuda_ms(lambda: log_mel(wav, fe), iters=10)
    plain_ms = cuda_ms(lambda: log_mel_plain(wav, fe), iters=10)
    results["log_mel"] = dict(
        max_abs_err=k1["main"]["err64"], ms=ms, plain_ms=plain_ms,
        gate=f"atol {K1_ATOL} from float64 (main {k1['main']['err64']:.3e}, "
             f"quiet {k1['quiet']['err64']:.3e})")
    for label, r in k1.items():
        log(f"(b) K1 log_mel, {label} audio [{wav.shape[0]}] -> "
            f"[{got.shape[0]}, {got.shape[1]}]: from float64 kernel "
            f"{r['err64']:.3e} (atol {K1_ATOL}), plain f32 "
            f"{r['plain_err64']:.3e}; kernel vs plain {r['diff']:.3e}")
    log(f"(b) K1 log_mel: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")

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
        results[name] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            gate=f"bf16 rel err from plain f32 {e_k:.5f} <= 2 x plain bf16 "
                 f"{e_p:.5f} + 1e-3; {ulps:.2f} bf16 ulps from plain bf16 "
                 f"<= {ULPS}")
        log(f"(c) {name} at {[tuple(x.shape) for x in xs]}: gate err {e_k:.5f} vs plain bf16 "
            f"{e_p:.5f}; vs plain bf16 max abs {err:.3e} = {ulps:.2f} ulps; "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        del xs, got, plain16
    # K2's stem kernel alone (its private entry: these launches count
    # nowhere), on the real windows
    stem = (spec_t, packed.k_eff, packed.b_eff, packed.pos_freq, n_frame)
    err, ulps = ulp_distance(lf._stem_embed(*stem),
                             lf.stem_embed_plain(*stem, torch.bfloat16))
    if not ulps <= ULPS:
        raise AssertionError(f"stem kernel vs plain bf16 {err} = {ulps:.2f} "
                             f"ulps > {ULPS}")
    stem_ms = cuda_ms(lambda: lf._stem_embed(*stem))
    stem_plain_ms = cuda_ms(lambda: lf.stem_embed_plain(*stem,
                                                        torch.bfloat16))
    log(f"(c) K2's stem kernel alone: vs plain bf16 max abs {err:.3e} = "
        f"{ulps:.2f} ulps; kernel {stem_ms:.3f} ms, plain (f32 conv + bias, "
        f"scale, pos) {stem_plain_ms:.3f} ms")

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
        bound = ULPS_FORWARD[k[-1]]
        if not ulps <= bound:
            failed.append(f"engine {k}: {ulps:.1f} ulps from plain bf16 > "
                          f"{bound}")
        log(f"(e) {k}: engine err {e_k:.5f} vs plain bf16 err {e_p:.5f}; "
            f"engine vs plain bf16 max abs {err:.4f} = {ulps:.1f} ulps "
            f"(<= {bound}) of max |plain bf16| "
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

    if "jax" in sys.modules or "flax" in sys.modules:
        raise AssertionError("JAX was imported")
    sources = {
        "log_mel": ("log_mel.cu", "spectrogram_pallas.py:124"),
        "encoder_layer_with_stem": ("stem_embed.cu", "layer_fused.py:376"),
        "encoder_layer": ("layer_fused.cu", "layer_fused.py:301"),
        "decoder_layer_zero": ("layer_fused.cu", "layer_fused.py:405"),
        "decoder_layer": ("layer_fused.cu", "layer_fused.py:429")}
    log(card)  # name, power limit: nvidia-smi's own line
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"nylon_amt_tpu_torch/csrc/{src}",
         "replaces": f"nylon_amt_tpu/ops/{tpu}", "launches": counts[name],
         **results[name]}
        for name, (src, tpu) in sources.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
