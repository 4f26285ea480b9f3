"""End-to-end learning proof of the port on synthetic audio.

The port's counterpart of ``scripts/e2e_learning_proof.py``: it generates a
synthetic corpus, trains the reduced-recipe hFT on it (hid 64 / pf 128 /
2+2 layers / 2 heads, dropout 0.1, batch 8, lr 1e-3, n_slice 4) with the
port's :class:`~nylon_amt_tpu_torch.train.loop.Trainer`, transcribes a
HELD-OUT set of pieces with the port's
:class:`~nylon_amt_tpu_torch.infer.transcribe.Transcriber`, and scores
note-level P/R/F1 (with and without offsets and velocity) per piece and
as a corpus mean, against the ground truth, with
:func:`~nylon_amt_tpu_torch.metrics.harness.score_notes`.

On ``--device cuda`` every feature comes from the log-mel kernel (K1), the
training steps run the training layer kernels (K6-K9) and the transcription
the inference ones (K2-K5; ``--int8-score`` also K13).

Two corpus styles:

* ``--style rich`` (default): MIDI-driven pieces with CC64 sustain spans,
  same-pitch re-onsets, chords, a full velocity spread and a mid-piece
  tempo change, made through the SMF writer -> ``midi2note`` -> synthesis
  path (:mod:`nylon_amt_tpu_torch.tools.proof_corpus`);
* ``--style legacy``: sparse monophonic pieces.

Both the final state and the best-validation checkpoint are scored; the run
passes when the better mean held-out onset F1 reaches ``--pass-f1``. It
also measures the training step on the device: a ``torch.profiler``
window of 20 steps in the second epoch this process trains (device-busy
time over the window's wall time, and the window's steps/s). Run from the
root of a checkout::

    python -m nylon_amt_tpu_torch.tools.learning_proof --style rich \\
        --pieces 56 --held-out 8 --epochs 25 --dtype bfloat16 \\
        --int8-score --device cuda

It prints the card's name and power limit first, the result as JSON, then
``LEARNING PROOF: PASS`` (exit code 0) or ``FAIL`` (1). SIGTERM or SIGUSR1
stop the training at the next batch boundary with its state saved in
``--out`` (exit code 3, nothing scored): ``--resume`` finishes the run.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np
import torch

from nylon_amt_tpu_torch.config import Config, ModelConfig, TrainConfig

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
WINDOW_STEPS = 20      # steps of the profiled window
WINDOW_START = 100     # its first step within the epoch


def card_line(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, or the device."""
    if device.type != "cuda":
        return f"device: {device} (no card)"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"{torch.cuda.get_device_name(device)} (nvidia-smi: {e})"


def synth_piece(rng, sr=16000, dur=20.0, n_notes=40, pitch_lo=48,
                pitch_hi=84):
    """Random monophonic-ish piece with decaying-harmonic tones (the legacy
    style of ``scripts/e2e_learning_proof.py``)."""
    t_all = np.arange(int(dur * sr)) / sr
    wav = np.zeros_like(t_all)
    notes = []
    onset = 0.2
    for _ in range(n_notes):
        pitch = int(rng.integers(pitch_lo, pitch_hi))
        length = float(rng.uniform(0.15, 0.5))
        vel = int(rng.integers(50, 110))
        f0 = 440.0 * 2 ** ((pitch - 69) / 12)
        seg = (t_all >= onset) & (t_all < onset + length)
        t = t_all[seg] - onset
        amp = (vel / 127.0) * 0.4 * np.exp(-t * 4.0)
        tone = np.sin(2 * np.pi * f0 * t) + 0.4 * np.sin(4 * np.pi * f0 * t) \
            + 0.15 * np.sin(6 * np.pi * f0 * t)
        wav[seg] += amp * tone
        notes.append({"pitch": pitch, "onset": round(onset, 4),
                      "offset": round(onset + length, 4), "velocity": vel})
        onset += float(rng.uniform(0.18, 0.45))
        if onset > dur - 1.0:
            break
    return np.clip(wav, -1, 1).astype(np.float32), notes


class ProfiledWindow:
    """The measured window of one train shard, driven by the trainer's
    ``step_hook`` (called on the main thread before every step with its
    index in the epoch): before step ``WINDOW_START`` it synchronises the
    card and starts ``torch.profiler``, and ``WINDOW_STEPS`` steps later it
    synchronises and stops it. The steps between are the trainer's own, on
    whichever input path the shard takes (the device epoch or host
    batches)."""

    def __init__(self, steps_per_epoch: int, device: torch.device):
        self.device = device
        self.steps = min(WINDOW_STEPS, steps_per_epoch - 1)
        self.start = min(WINDOW_START, steps_per_epoch - 1 - self.steps)
        self.result = None
        self._prof = None
        self._t0 = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, i: int) -> None:
        from torch.autograd import DeviceType

        from nylon_amt_tpu_torch.utils.profiling import activities

        if i == self.start and self.steps > 0:
            self._sync()
            self._prof = torch.profiler.profile(activities=activities())
            self._prof.start()
            self._t0 = time.perf_counter()
        elif i == self.start + self.steps and self._prof is not None:
            self._sync()
            wall = time.perf_counter() - self._t0
            self._prof.stop()
            self.result = {
                "steps": self.steps, "first_step": self.start,
                "wall_s": wall, "steps_per_sec": self.steps / wall,
                "device_busy_s": None, "busy_share": None,
                "idle_share": None}
            if self.device.type == "cuda":
                # device-side annotations (Optimizer.step#...) span
                # kernels already counted
                busy = sum(e.self_device_time_total for e in
                           self._prof.key_averages()
                           if e.device_type == DeviceType.CUDA
                           and not e.is_user_annotation) / 1e6
                self.result.update(device_busy_s=busy,
                                   busy_share=busy / wall,
                                   idle_share=1.0 - busy / wall)
            self._prof = None

    def close(self) -> None:
        """Stop a window that the epoch did not finish (a preemption)."""
        if self._prof is not None:
            self._prof.stop()
            self._prof = None


def build_config(args) -> Config:
    return Config(
        model=ModelConfig(hid_dim=64, pf_dim=128, enc_layer=2, dec_layer=2,
                          enc_head=2, dec_head=2, dropout=0.1,
                          compute_dtype=args.dtype,
                          remat=args.attention_impl == "per-site"),
        # constant lr by default: the plateau scheduler watches the total
        # valid loss, which the (hard) velocity/offset heads dominate
        train=TrainConfig(epochs=args.epochs, batch_size=8, lr=args.lr,
                          n_slice=args.n_slice,
                          plateau_patience=args.patience,
                          plateau_factor=args.plateau_factor))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--pieces", type=int, default=16)
    ap.add_argument("--dur", type=float, default=20.0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--n-slice", type=int, default=4)
    ap.add_argument("--patience", type=int, default=10_000,
                    help="plateau-scheduler patience (epochs); the default "
                    "effectively disables lr decay")
    ap.add_argument("--plateau-factor", type=float, default=0.1)
    ap.add_argument("--attention-impl", default="fused",
                    choices=["fused", "per-site"],
                    help="'fused': the training layer kernels (K7-K9); "
                    "'per-site': the per-site attention kernels (K10-K12), "
                    "as --remat trains")
    ap.add_argument("--n-notes", type=int, default=40,
                    help="notes per legacy piece")
    ap.add_argument("--style", default="rich", choices=["rich", "legacy"])
    ap.add_argument("--held-out", type=int, default=8,
                    help="number of held-out test pieces")
    ap.add_argument("--pass-f1", type=float, default=0.70,
                    help="PASS threshold on mean held-out onset F1")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "learning_proof"))
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest checkpoint in --out")
    ap.add_argument("--init-from", default=None,
                    help="warm-start params from this checkpoints/ dir's "
                    "best (fresh optimizer / scheduler)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"],
                    help="the model's compute dtype")
    ap.add_argument("--int8-score", action="store_true",
                    help="also score the best checkpoint through the W8A8 "
                    "layers (Transcriber(precision='int8'))")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda runs the kernels, cpu the plain "
                    "versions")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s %(levelname)s %(name)s: "
                        "%(message)s", datefmt="%H:%M:%S")

    from nylon_amt_tpu_torch.cli import load_model
    from nylon_amt_tpu_torch.data.corpus import assemble_split
    from nylon_amt_tpu_torch.data.windows import WindowDataset
    from nylon_amt_tpu_torch.infer.transcribe import Transcriber
    from nylon_amt_tpu_torch.labels import note2label
    from nylon_amt_tpu_torch.metrics.harness import score_notes
    from nylon_amt_tpu_torch.models import fused_train
    from nylon_amt_tpu_torch.ops.mel import MelFrontend
    from nylon_amt_tpu_torch.tools import proof_corpus
    from nylon_amt_tpu_torch.train.loop import Trainer

    device = torch.device(args.device)
    print(card_line(device), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    cfg = build_config(args)
    print(f"train path: "
          f"{'fused layers' if fused_train.supports(cfg) else 'per-site'} "
          f"(compute dtype {args.dtype}, patience {args.patience})",
          flush=True)
    rng = np.random.default_rng(42)
    frontend = MelFrontend(cfg.feature, device)

    def make_piece(i):
        if args.style == "rich":
            os.makedirs(os.path.join(args.out, "midi"), exist_ok=True)
            return proof_corpus.synth_rich_piece(
                rng, cfg, os.path.join(args.out, "midi", f"piece_{i:03d}.mid"),
                dur=args.dur)
        return synth_piece(rng, dur=args.dur, n_notes=args.n_notes)

    def features(wav):
        return frontend(wav).cpu().numpy()

    t0 = time.time()
    train_pieces, valid_pieces = [], []
    for i in range(args.pieces + 2):
        wav, notes = make_piece(i)
        feat = features(wav)
        labels = note2label(cfg, notes, nframe=feat.shape[0])
        (train_pieces if i < args.pieces else valid_pieces).append(
            (feat, labels))
    # held-out test pieces (never trained or validated on)
    test_set = [make_piece(10_000 + j) for j in range(args.held_out)]
    print(f"corpus built in {time.time() - t0:.0f}s "
          f"(style={args.style}, {args.pieces} train / 2 valid / "
          f"{args.held_out} held-out)", flush=True)

    train_arrays = assemble_split(cfg, *zip(*train_pieces))
    valid_arrays = assemble_split(cfg, *zip(*valid_pieces))
    shards = {"train": 0}
    window = {}

    def provider(split, div):
        arrays = train_arrays if split == "train" else valid_arrays
        ds = WindowDataset(arrays, cfg, n_slice=cfg.train.n_slice)
        if split == "train":
            shards["train"] += 1
            if "ds" in window:            # the measured epoch is over
                window["ds"].close()
                trainer.step_hook = None
            if shards["train"] == 2:
                window["ds"] = trainer.step_hook = ProfiledWindow(
                    ds.steps_per_epoch, device)
        return ds

    state = None
    if args.init_from:
        from nylon_amt_tpu_torch.cli import warm_start

        state = warm_start(cfg, args.init_from, None, None, device)
        print(f"warm start from {args.init_from}", flush=True)

    trainer = Trainer(cfg, args.out, device=device)
    steps_per_epoch = WindowDataset(train_arrays, cfg,
                                    n_slice=cfg.train.n_slice).steps_per_epoch
    t0 = time.time()
    state = trainer.fit(provider, state=state,
                        resume="auto" if args.resume else None)
    train_s = time.time() - t0
    if trainer.preempted:
        print(f"preempted after {train_s:.0f}s: the state from before the "
              f"interrupted epoch is saved in {args.out}; rerun with "
              f"--resume to finish", flush=True)
        return 3
    epochs_run = shards["train"]
    print(f"training took {train_s:.0f}s for {epochs_run} epochs of "
          f"{steps_per_epoch} steps; losses "
          f"{trainer.performance['loss_train'][:2]} ... "
          f"{trainer.performance['loss_train'][-2:]}", flush=True)

    test_feats = [features(w) for w, _ in test_set]

    def score(model, precision=None):
        tr = Transcriber(cfg, model, device, batch_windows=8,
                         precision=precision)
        pieces = []
        for feat, (_, ref_notes) in zip(test_feats, test_set):
            post = tr.transcript(feat)
            # mode_velocity='org': velocity classification needs far more
            # data than onset detection; the default ignore_zero mode would
            # drop every detected note at this corpus scale
            notes = tr.mpe2note(post["onset_B"], post["offset_B"],
                                post["mpe_B"], post["velocity_B"],
                                mode_velocity="org")
            s = score_notes(ref_notes, notes, with_velocity=True)
            pieces.append({
                "est_notes": len(notes), "ref_notes": len(ref_notes),
                "f1_no_offset": s["F-measure_no_offset"],
                "precision_no_offset": s["Precision_no_offset"],
                "recall_no_offset": s["Recall_no_offset"],
                "f1_with_offset": s["F-measure"],
                "f1_velocity": s["F-measure_velocity"],
                "precision_velocity": s["Precision_velocity"],
                "recall_velocity": s["Recall_velocity"],
            })
        mean = {k: round(float(np.mean([p[k] for p in pieces])), 4)
                for k in pieces[0] if k.startswith(("f1", "precision",
                                                    "recall"))}
        return {"mean": mean, "per_piece": pieces}

    # Score both the final state (the reference's end-of-training test pass)
    # and the best-valid checkpoint (its best_model.pkl workflow).
    result = {"final": score(state.model)}
    if trainer.ckpt.best_tag() is not None:
        best = load_model(trainer.ckpt.directory, cfg, device)
        result["best"] = score(best)
        result["best_epoch"] = trainer.best_epoch
        if args.int8_score:
            result["best_int8"] = score(best, precision="int8")
    result["loss_first"] = trainer.performance["loss_train"][0]
    result["loss_last"] = trainer.performance["loss_train"][-1]
    result["style"] = args.style
    result["dtype"] = args.dtype
    result["device"] = (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else str(device))
    result["train"] = {
        "seconds": train_s, "epochs_this_process": epochs_run,
        "steps_per_epoch": steps_per_epoch,
        "steps_per_sec_overall": epochs_run * steps_per_epoch / train_s
        if train_s else None,
        "window": window["ds"].result if "ds" in window else None}
    print(json.dumps(result, indent=2))
    w = result["train"]["window"]
    if w is not None and w["busy_share"] is not None:
        print(f"train step, {w['steps']} steps of this process's second "
              f"epoch (batch 8): "
              f"{w['steps_per_sec']:.2f} steps/s, device-busy "
              f"{w['busy_share']:.1%} of {w['wall_s'] * 1e3:.1f} ms wall, "
              f"idle {w['idle_share']:.1%} (torch.profiler); overall "
              f"{result['train']['steps_per_sec_overall']:.2f} steps/s "
              f"with validation and checkpoints")
    else:
        print("train step's device-busy share: not measured (no card, or "
              "no second epoch in this process)")
    ok = max(result["final"]["mean"]["f1_no_offset"],
             result.get("best", {}).get("mean", {}).get("f1_no_offset", 0.0)
             ) >= args.pass_f1
    print("LEARNING PROOF:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
