"""Classical-guitar fine-tune proof of the port: piano warm start against
training from scratch, with the learned tablature head.

The port's counterpart of ``scripts/finetune_guitar_proof.py``, with its
own copy of that script's corpus synthesis and its recipe. The reference
repo's stated goal is classical-guitar transcription by reusing the
piano-trained hFT stack; this tool runs that workflow on synthetic audio:

1. synthesize a plucked-string guitar corpus (additive inharmonic plucks,
   E2-B5): every note is assigned a string (uniform among the strings that
   reach its pitch at fret <= 12), and each string has its own
   inharmonicity, spectral rolloff and damping, so the string is audible
   rather than a function of pitch;
2. fine-tune the reduced-recipe model (hid 64 / pf 128 / 2+2 layers / 2
   heads, dropout 0.1, bfloat16, batch 8) **with the tab head**
   (``ModelConfig.tab_head``) from a piano checkpoint (``cli train
   --init-from`` semantics: the checkpoint's parameters merged into a fresh
   state, the head at its fresh initialisation), and, as the control,
   train the same architecture from scratch on the same corpus;
3. transcribe a held-out piece with both, score note-level onset F1, and
   score the head's strings on the correctly detected notes beside the
   lowest-fret rule's.

Pass rule (the JAX script's): the fine-tuned model's onset F1 on the
held-out piece is at least 0.75 and above the control's. String accuracy
is reported, not gated.

On ``--device cuda`` the corpus and the transcriptions run K1, training
the training layer kernels (K6-K9) fed by the device-resident epoch, and
the transcriptions the inference kernels (K2-K5) with the string head.
The piano checkpoint comes from :mod:`nylon_amt_tpu_torch.tools.
learning_proof`; run from the root of a checkout::

    python -m nylon_amt_tpu_torch.tools.learning_proof --style rich \\
        --pieces 56 --held-out 8 --epochs 20 --dtype bfloat16 \\
        --device cuda --out build/lp
    python -m nylon_amt_tpu_torch.tools.guitar_proof \\
        --init-from build/lp/checkpoints --epochs 8 --device cuda

It prints the card's name and power limit first, the result as JSON, then
``GUITAR FINETUNE PROOF: PASS`` (exit code 0) or ``FAIL`` (1). SIGTERM or
SIGUSR1 stop the training at the next batch boundary with its state saved
under ``--out`` (exit code 3, nothing scored): ``--resume`` continues each
arm from its newest checkpoint.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from nylon_amt_tpu_torch.config import Config, ModelConfig, TrainConfig
from nylon_amt_tpu_torch.infer.tab import STANDARD_TUNING
from nylon_amt_tpu_torch.tools.learning_proof import card_line

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MAX_FRET = 12
CORPUS_SEED = 7          # np.random.default_rng seed of the corpus
# Per-string signatures, string 1 (high E) .. string 6 (low E): the
# inharmonicity B (partial k at k f0 sqrt(1 + B k^2)) grows ~20x from the
# high E to the wound low E, the spectral rolloff (partial amplitude
# k^-rolloff) darkens thick strings, the damping (amplitude e-folds a
# second) shortens thin strings' ring; the pick transient is smoothed more
# on thick strings.
STRING_INHARM = (2e-5, 4e-5, 8e-5, 1.6e-4, 2.7e-4, 4.0e-4)
STRING_ROLLOFF = (0.7, 0.9, 1.1, 1.35, 1.6, 1.9)
STRING_DAMP = (3.2, 2.9, 2.6, 2.2, 1.9, 1.6)
STRING_DARKEN = (0, 1, 2, 3, 4, 5)


def pluck_additive(rng, f0: float, n: int, sr: int, string: int,
                   n_partials: int = 14) -> np.ndarray:
    """Inharmonic additive pluck of ``n`` samples with the string's
    inharmonicity, rolloff and damping."""
    B = STRING_INHARM[string - 1]
    roll = STRING_ROLLOFF[string - 1]
    damp = STRING_DAMP[string - 1]
    t = np.arange(n) / sr
    wav = np.zeros(n)
    for k in range(1, n_partials + 1):
        fk = k * f0 * np.sqrt(1.0 + B * k * k)
        if fk > 0.45 * sr:
            break
        amp = k ** -roll * np.exp(-t * damp * (1 + 0.35 * (k - 1)))
        wav += amp * np.sin(2 * np.pi * fk * t + rng.uniform(0, 2 * np.pi))
    wav *= np.minimum(1.0, t / 0.004)          # 4 ms attack
    burst = rng.uniform(-1, 1, min(n, int(0.006 * sr)))
    for _ in range(STRING_DARKEN[string - 1]):
        burst = 0.5 * (burst + np.roll(burst, 1))
    wav[:burst.size] += 0.6 * burst * np.linspace(1, 0, burst.size)
    return 0.5 * wav


def feasible_strings(pitch: int, max_fret: int = MAX_FRET) -> list[int]:
    return [s for s, open_pitch in enumerate(STANDARD_TUNING, start=1)
            if 0 <= pitch - open_pitch <= max_fret]


def synth_guitar_piece(rng, sr=16000, dur=20.0, n_notes=40, pitch_lo=40,
                       pitch_hi=76) -> tuple[np.ndarray, list[dict]]:
    """A random guitar-range piece of plucks, each note on a string drawn
    among those that reach its pitch."""
    wav = np.zeros(int(dur * sr))
    notes = []
    onset = 0.2
    for _ in range(n_notes):
        pitch = int(rng.integers(pitch_lo, pitch_hi))
        feas = feasible_strings(pitch)
        if not feas:
            continue
        string = int(feas[rng.integers(len(feas))])
        length = float(rng.uniform(0.15, 0.5))
        vel = int(rng.integers(50, 110))
        f0 = 440.0 * 2 ** ((pitch - 69) / 12)
        i0 = int(onset * sr)
        n = min(int(length * sr), wav.size - i0)
        if n <= 0:
            break
        wav[i0:i0 + n] += (vel / 127.0) * pluck_additive(rng, f0, n, sr,
                                                          string)
        notes.append({"pitch": pitch, "onset": round(onset, 4),
                      "offset": round(onset + n / sr, 4), "velocity": vel,
                      "string": string})
        onset += float(rng.uniform(0.18, 0.45))
        if onset > dur - 1.0:
            break
    return np.clip(wav, -1, 1).astype(np.float32), notes


def string_scores(est_notes: list[dict], ref_notes: list[dict]) -> dict:
    """String accuracy of annotated notes over the correctly detected ones
    (same pitch, onset within 50 ms), beside the lowest-fret rule's on the
    same matches."""
    matched = same = rule_same = 0
    by_pitch: dict[int, list[dict]] = {}
    for r in ref_notes:
        by_pitch.setdefault(r["pitch"], []).append(r)
    for e in est_notes:
        cands = [r for r in by_pitch.get(e["pitch"], ())
                 if abs(r["onset"] - e["onset"]) <= 0.05]
        if not cands:
            continue
        r = min(cands, key=lambda r: abs(r["onset"] - e["onset"]))
        matched += 1
        same += int(e.get("string") == r["string"])
        feas = feasible_strings(r["pitch"])
        lowest = min(feas, key=lambda s: r["pitch"] - STANDARD_TUNING[s - 1]
                     ) if feas else 0
        rule_same += int(lowest == r["string"])
    return {"matched": matched,
            "string_acc": round(same / matched, 4) if matched else 0.0,
            "lowest_fret_rule_acc":
                round(rule_same / matched, 4) if matched else 0.0}


def build_config(args, lr: float, tab_head: bool = True,
                 epochs: int | None = None) -> Config:
    """The JAX script's recipe (``scripts/finetune_guitar_proof.py:
    201-214``)."""
    return Config(
        model=ModelConfig(hid_dim=64, pf_dim=128, enc_layer=2, dec_layer=2,
                          enc_head=2, dec_head=2, dropout=0.1,
                          compute_dtype="bfloat16", tab_head=tab_head),
        train=TrainConfig(epochs=epochs or args.epochs, batch_size=8, lr=lr,
                          n_slice=args.n_slice,
                          plateau_patience=args.patience,
                          plateau_factor=args.plateau_factor))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--init-from", required=True,
                    help="the piano run's checkpoints/ dir (its best "
                    "checkpoint is used), or a run dir holding one")
    ap.add_argument("--pieces", type=int, default=24)
    ap.add_argument("--n-notes", type=int, default=40,
                    help="notes per synthesized piece")
    ap.add_argument("--dur", type=float, default=20.0)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--epochs-scratch", type=int, default=None,
                    help="epochs of the from-scratch control (default: "
                    "--epochs)")
    ap.add_argument("--lr-ft", type=float, default=3e-4)
    ap.add_argument("--lr-scratch", type=float, default=1e-3)
    ap.add_argument("--n-slice", type=int, default=4)
    ap.add_argument("--plateau-factor", type=float, default=0.5)
    ap.add_argument("--patience", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "guitar_proof"))
    ap.add_argument("--skip-scratch", action="store_true",
                    help="only run the fine-tune arm")
    ap.add_argument("--skip-zero-shot", action="store_true",
                    help="do not score the piano checkpoint unadapted")
    ap.add_argument("--resume", action="store_true",
                    help="continue each arm from its newest checkpoint in "
                    "--out")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda runs the kernels, cpu the plain "
                    "versions")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(asctime)s %(levelname)s %(name)s: "
                        "%(message)s", datefmt="%H:%M:%S")

    from nylon_amt_tpu_torch.cli import load_model, warm_start
    from nylon_amt_tpu_torch.data.corpus import assemble_split
    from nylon_amt_tpu_torch.data.windows import WindowDataset
    from nylon_amt_tpu_torch.infer.tab import annotate_strings, to_alphatex
    from nylon_amt_tpu_torch.infer.transcribe import Transcriber
    from nylon_amt_tpu_torch.labels import note2label
    from nylon_amt_tpu_torch.metrics.harness import score_notes
    from nylon_amt_tpu_torch.ops.mel import MelFrontend
    from nylon_amt_tpu_torch.train.loop import Trainer

    device = torch.device(args.device)
    print(card_line(device), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    cfg = build_config(args, args.lr_ft)
    rng = np.random.default_rng(CORPUS_SEED)
    frontend = MelFrontend(cfg.feature, device)

    def features(wav):
        return frontend(wav).cpu().numpy()

    t0 = time.time()
    train_pieces, valid_pieces = [], []
    for i in range(args.pieces + 2):
        wav, notes = synth_guitar_piece(rng, dur=args.dur,
                                        n_notes=args.n_notes)
        feat = features(wav)
        labels = note2label(cfg, notes, nframe=feat.shape[0], strings=True)
        (train_pieces if i < args.pieces else valid_pieces).append(
            (feat, labels))
    test_wav, test_notes = synth_guitar_piece(rng, dur=args.dur,
                                              n_notes=args.n_notes)
    test_feat = features(test_wav)
    print(f"guitar corpus built in {time.time() - t0:.0f}s "
          f"({args.pieces}+2 pieces, {len(test_notes)} held-out notes)",
          flush=True)
    train_arrays = assemble_split(cfg, *zip(*train_pieces))
    valid_arrays = assemble_split(cfg, *zip(*valid_pieces))

    def provider(split, div):
        arrays = train_arrays if split == "train" else valid_arrays
        return WindowDataset(arrays, cfg, n_slice=cfg.train.n_slice)

    def score(model, c: Config) -> dict:
        tr = Transcriber(c, model, device, batch_windows=8)
        post = tr.transcript(test_feat)
        notes = tr.mpe2note(post["onset_B"], post["offset_B"],
                            post["mpe_B"], post["velocity_B"],
                            mode_velocity="org")
        s = score_notes(test_notes, notes, with_velocity=False)
        r = {"est_notes": len(notes), "ref_notes": len(test_notes),
             "f1_no_offset": s["F-measure_no_offset"],
             "precision_no_offset": s["Precision_no_offset"],
             "recall_no_offset": s["Recall_no_offset"]}
        if "string_B" in post:
            annotated = annotate_strings(notes, post["string_B"], c)
            r.update(string_scores(annotated, test_notes))
            r["alphatex_lines"] = len(to_alphatex(annotated).splitlines())
        return r

    def run(tag: str, lr: float, init_from: str | None = None,
            epochs: int | None = None) -> dict | None:
        c = build_config(args, lr, epochs=epochs)
        state = (warm_start(c, init_from, None, None, device)
                 if init_from else None)
        trainer = Trainer(c, os.path.join(args.out, tag), device=device)
        t0 = time.time()
        final = trainer.fit(provider, state=state,
                            resume="auto" if args.resume else None)
        secs = time.time() - t0
        if trainer.preempted:
            return None
        steps = len(trainer.performance["loss_train"]) * \
            provider("train", 0).steps_per_epoch
        r = {"train_s": round(secs, 1), "best_epoch": trainer.best_epoch,
             "loss_first": trainer.performance["loss_train"][0],
             "loss_last": trainer.performance["loss_train"][-1],
             "uploads": [[n, round(s, 4)] for n, s in trainer.uploads],
             "final": score(final.model, c)}
        if trainer.ckpt.best_tag() is not None:
            r["best"] = score(load_model(trainer.ckpt.directory, c, device),
                              c)
        r["f1"] = max(r["final"]["f1_no_offset"],
                      r.get("best", {}).get("f1_no_offset", 0.0))
        print(f"[{tag}] f1={r['f1']:.3f} ({secs:.0f}s for the epochs this "
              f"process ran; {steps} steps in all)", flush=True)
        return r

    init_dir = args.init_from
    if os.path.isdir(os.path.join(init_dir, "checkpoints")):
        init_dir = os.path.join(init_dir, "checkpoints")
    result = {}
    if not args.skip_zero_shot:
        # the piano checkpoint on guitar audio, unadapted (no tab head)
        plain = build_config(args, args.lr_ft, tab_head=False)
        result["zero_shot"] = score(load_model(init_dir, plain, device),
                                    plain)
        print(f"[zero-shot] f1={result['zero_shot']['f1_no_offset']:.3f}",
              flush=True)
    arms = [("finetune", args.lr_ft, init_dir, None)]
    if not args.skip_scratch:
        arms.append(("scratch", args.lr_scratch, None, args.epochs_scratch))
    for tag, lr, init_from, epochs in arms:
        r = run(tag, lr, init_from, epochs)
        if r is None:
            print(f"preempted in the {tag} arm: its state is saved in "
                  f"{args.out}; rerun with --resume to finish", flush=True)
            return 3
        result[tag] = r
    ft = result["finetune"]["f1"]
    sc = result.get("scratch", {}).get("f1", 0.0)
    result["pass"] = bool(ft >= 0.75 and ft > sc)
    result["device"] = (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else str(device))
    print(json.dumps(result, indent=2))
    print("GUITAR FINETUNE PROOF:", "PASS" if result["pass"] else "FAIL")
    return 0 if result["pass"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
