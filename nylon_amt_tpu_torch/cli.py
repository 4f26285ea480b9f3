"""Command-line interface of the PyTorch / CUDA port: ``train``,
``transcribe`` and ``evaluate``.

``train`` runs the (epoch, div) training recipe on split arrays written by
the corpus step (``<split>_feature.npy``, ... as ``data/corpus.py`` saves
them), through the training layer kernels on ``--device cuda`` or their
plain versions on ``--device cpu`` (with ``--remat``, a
``return_attention`` config or an ablation model, through the per-site
attention kernels):

    python -m nylon_amt_tpu_torch.cli train --config config.json \
        --dataset corpus/ --out run/ --device cuda

and writes ``parameter.json``, ``performance.json`` and
``checkpoints/model_EEE_DDD/model.dat`` (the reference's format).

``transcribe``: WAV -> posteriors -> note events -> MIDI (+ JSON), as
``python -m nylon_amt_tpu.cli transcribe`` does:

    python -m nylon_amt_tpu_torch.cli transcribe --checkpoint model.dat \\
        --config config.json --wav piece.wav --out out/ --device cuda

``--checkpoint`` is a reference-format ``.dat`` (a ``torch.save`` dict with
``model_dict``) or a bare ``state_dict`` with the reference's key names.
Writes ``<stem>.mid``, ``<stem>.notes.json`` and one
``<stem>_{1st,2nd}.notes.json`` per head family; ``--tab`` adds
``<stem>.alphatex``, ``--sheet`` ``<stem>.musicxml`` and
``--save-posteriors`` ``<stem>.post.npz``. ``--list DIR --split S``
transcribes every WAV of a lists directory's split; ``--int8`` runs the
W8A8 layers.

``evaluate``: note-level and frame-level scores of transcriptions against
reference MIDI, as JSON (the reference's EXE-EVALUATION-MAESTRO flow):

    python -m nylon_amt_tpu_torch.cli evaluate --list lists/ --split test \
        --est-dir out/ --out scores.json

Each ``--pair REF.mid:EST`` (or each split entry with ``--list``) scores an
estimate: a ``.notes.json`` or MIDI file by note and frame metrics, a
``.post.npz`` by its thresholded MPE posteriors.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from nylon_amt_tpu_torch.config import Config
from nylon_amt_tpu_torch.midi.smf import write_notes
from nylon_amt_tpu_torch.infer.transcribe import Transcriber
from nylon_amt_tpu_torch.models.hft import build_model


def load_model(path: str, config: Config, device: torch.device | str):
    """Reference ``.dat`` / bare ``state_dict`` -> the config's model
    (:func:`build_model`) on ``device`` (strict key match)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj["model_dict"] if isinstance(obj, dict) and "model_dict" in obj \
        else obj
    model = build_model(config, device)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def cmd_train(args) -> int:
    from nylon_amt_tpu_torch.data.corpus import SplitArrays
    from nylon_amt_tpu_torch.data.windows import WindowDataset
    from nylon_amt_tpu_torch.train.loop import Trainer

    config = Config.load(args.config) if args.config else Config()
    overrides = {f: getattr(args, f) for f in
                 ("epochs", "batch_size", "lr", "n_slice", "seed",
                  "keep_checkpoints") if getattr(args, f) is not None}
    if overrides:
        config = dataclasses.replace(
            config, train=dataclasses.replace(config.train, **overrides))
    if args.remat:
        config = dataclasses.replace(
            config, model=dataclasses.replace(config.model, remat=True))
    t = config.train

    def provider(split: str, div: int) -> WindowDataset:
        n_div = {"train": t.n_div_train, "valid": t.n_div_valid,
                 "test": t.n_div_test}[split]
        arrays = SplitArrays.load(args.dataset, split,
                                  shard=div if n_div > 1 else None)
        return WindowDataset(arrays, config, n_slice=t.n_slice)

    trainer = Trainer(config, args.out, device=args.device)
    resume = ("auto" if args.resume_auto
              else tuple(args.resume) if args.resume else None)
    trainer.fit(provider, resume=resume)
    print(f"training done; best valid loss {trainer.best_loss_valid:.5f} "
          f"(epoch {trainer.best_epoch} div {trainer.best_div})")
    return 0


def cmd_transcribe(args) -> int:
    config = Config.load(args.config) if args.config else Config()
    model = load_model(args.checkpoint, config, args.device)
    tr = Transcriber(config, model, args.device,
                     batch_windows=args.batch_windows,
                     precision="int8" if args.int8 else None)
    wavs = list(args.wav or [])
    if args.list:
        # the EXE-EVALUATION-MAESTRO flow: every WAV of a split
        from nylon_amt_tpu_torch.data.lists import CorpusList

        wavs += [w for _, w, _ in CorpusList.load(args.list)
                 .entries[args.split]]
    if not wavs:
        print("transcribe: no input (--wav or --list required)",
              file=sys.stderr)
        return 2
    # Head families, reference naming: stage-1 "A" heads -> _1st, stage-2
    # "B" heads -> _2nd; single mode emits only _1st.
    families = ([("1st", "A"), ("2nd", "B")] if args.mode == "combination"
                else [("1st", "A")])
    for wav in wavs:
        feature = tr.wav2feature(wav)
        if args.stride >= 0:
            post = tr.transcript_stride(feature, args.stride, mode=args.mode)
        else:
            post = tr.transcript(feature, mode=args.mode)
        stem = os.path.splitext(os.path.basename(wav))[0]
        out_dir = args.out or os.path.dirname(wav) or "."
        os.makedirs(out_dir, exist_ok=True)
        notes = []
        for suffix, fam in families:
            notes = tr.mpe2note(
                post[f"onset_{fam}"], post[f"offset_{fam}"],
                post[f"mpe_{fam}"], post[f"velocity_{fam}"],
                thred_onset=args.thred_onset, thred_offset=args.thred_offset,
                thred_mpe=args.thred_mpe, mode_offset=args.mode_offset)
            with open(os.path.join(out_dir, f"{stem}_{suffix}.notes.json"),
                      "w") as f:
                json.dump(notes, f, indent=2)
        # MIDI from the last-decoded family (B in combination mode).
        write_notes(os.path.join(out_dir, stem + ".mid"), notes)
        with open(os.path.join(out_dir, stem + ".notes.json"), "w") as f:
            json.dump(notes, f, indent=2)
        if args.tab:
            from nylon_amt_tpu_torch.infer.tab import write_alphatex

            write_alphatex(notes, os.path.join(out_dir, stem + ".alphatex"),
                           title=stem)
        if args.sheet:
            from nylon_amt_tpu_torch.infer.sheet import write_musicxml

            write_musicxml(notes, os.path.join(out_dir, stem + ".musicxml"),
                           title=stem)
        if args.save_posteriors:
            np.savez_compressed(os.path.join(out_dir, stem + ".post.npz"),
                                **post)
        print(f"{wav}: {len(notes)} notes -> {out_dir}/{stem}.mid")
    return 0


def cmd_evaluate(args) -> int:
    from nylon_amt_tpu_torch.labels import midi2note
    from nylon_amt_tpu_torch.metrics.harness import (
        aggregate,
        score_frames,
        score_mpe_posteriors,
        score_notes,
    )

    config = Config.load(args.config) if args.config else Config()
    pairs = list(args.pair or [])
    if args.list:
        # every split entry's reference MIDI against the artifact that
        # `transcribe --list` wrote for its WAV
        from nylon_amt_tpu_torch.data.lists import CorpusList

        for _, wav, midi in CorpusList.load(args.list).entries[args.split]:
            stem = os.path.splitext(os.path.basename(wav))[0]
            est = os.path.join(args.est_dir or ".", stem + args.suffix)
            pairs.append(f"{midi}:{est}")
    if not pairs:
        print("evaluate: no input (--pair or --list required)",
              file=sys.stderr)
        return 2
    fps, note_min = config.feature.frames_per_sec, config.midi.note_min
    num_note = config.midi.num_note
    per_file_notes, per_file_frames, per_file_mpe = {}, {}, {}
    for pair in pairs:
        ref_path, est_path = pair.split(":")
        ref_notes = midi2note(config, ref_path)
        name = os.path.basename(est_path)
        if est_path.endswith(".npz"):
            # frame scores of the thresholded MPE posteriors
            post = np.load(est_path)
            fam = "B" if "mpe_B" in post else "A"
            per_file_mpe[name] = score_mpe_posteriors(
                ref_notes, post[f"mpe_{fam}"], fps=fps, note_min=note_min,
                num_note=num_note)
            continue
        if est_path.endswith(".json"):
            with open(est_path) as f:
                est_notes = json.load(f)
        else:
            est_notes = midi2note(config, est_path)
        per_file_notes[name] = score_notes(ref_notes, est_notes)
        per_file_frames[name] = score_frames(
            ref_notes, est_notes, fps=fps, note_min=note_min,
            num_note=num_note)

    result = {"note": {"per_file": per_file_notes,
                       "mean": aggregate(per_file_notes)},
              "frame": {"per_file": per_file_frames,
                        "mean": aggregate(per_file_frames)}}
    if per_file_mpe:
        result["mpe_posterior"] = {"per_file": per_file_mpe,
                                   "mean": aggregate(per_file_mpe)}
    text = json.dumps(result, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nylon_amt_tpu_torch",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train", help="train the hFT model")
    t.add_argument("--config", help="config JSON (default: Config())")
    t.add_argument("--dataset", required=True,
                   help="directory of split arrays (data/corpus.py)")
    t.add_argument("--out", required=True)
    t.add_argument("--epochs", type=int)
    t.add_argument("--batch-size", type=int)
    t.add_argument("--lr", type=float)
    t.add_argument("--n-slice", type=int)
    t.add_argument("--seed", type=int)
    t.add_argument("--keep-checkpoints", type=int,
                   help="retain only the best + newest K checkpoints")
    t.add_argument("--remat", action="store_true",
                   help="rematerialize encoder/decoder activations in the "
                   "backward pass (gradient checkpointing); trains through "
                   "the per-site attention kernels")
    resume_group = t.add_mutually_exclusive_group()
    resume_group.add_argument("--resume", nargs=2, type=int,
                              metavar=("EPOCH", "DIV"))
    resume_group.add_argument("--resume-auto", action="store_true",
                              help="resume from the newest checkpoint on "
                              "disk")
    t.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the kernels, cpu the plain "
                   "versions")
    t.set_defaults(fn=cmd_train)
    r = sub.add_parser("transcribe", help="WAV -> MIDI")
    r.add_argument("--config", help="config JSON (default: Config())")
    r.add_argument("--checkpoint", required=True,
                   help="reference .dat or state_dict file")
    r.add_argument("--wav", nargs="+")
    r.add_argument("--list", help="lists dir ({split}.tsv): transcribe "
                   "every WAV of --split")
    r.add_argument("--split", default="test",
                   choices=["train", "valid", "test"])
    r.add_argument("--out", help="output directory (default: beside the WAV)")
    r.add_argument("--batch-windows", type=int, default=8)
    r.add_argument("--stride", type=int, default=-1,
                   help="half-window hop with this centre offset (frames); "
                   "-1 = plain hops")
    r.add_argument("--mode", choices=["combination", "single"],
                   default="combination")
    r.add_argument("--thred-onset", type=float, default=0.5)
    r.add_argument("--thred-offset", type=float, default=0.5)
    r.add_argument("--thred-mpe", type=float, default=0.5)
    r.add_argument("--mode-offset", default="shorter",
                   choices=["shorter", "longer", "offset"])
    r.add_argument("--save-posteriors", action="store_true",
                   help="also write <stem>.post.npz")
    r.add_argument("--tab", action="store_true",
                   help="also export guitar tablature (alphaTex)")
    r.add_argument("--sheet", action="store_true",
                   help="also export sheet music (MusicXML)")
    r.add_argument("--int8", action="store_true",
                   help="W8A8 layers: per-channel int8 weights, dynamic "
                   "per-row int8 activations; an approximation of the "
                   "default path (PERF.md has its error and speed)")
    r.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the kernels, cpu the plain "
                   "versions")
    r.set_defaults(fn=cmd_transcribe)
    e = sub.add_parser("evaluate", help="score estimated vs reference notes")
    e.add_argument("--config", help="config JSON (default: Config())")
    e.add_argument("--pair", nargs="+",
                   metavar="REF.mid:EST.{mid,json,post.npz}")
    e.add_argument("--list", help="lists dir ({split}.tsv): score every "
                   "file of --split against --est-dir artifacts")
    e.add_argument("--split", default="test",
                   choices=["train", "valid", "test"])
    e.add_argument("--est-dir",
                   help="directory of `transcribe` outputs (with --list)")
    e.add_argument("--suffix", default=".notes.json",
                   help="estimate filename suffix per WAV stem (e.g. "
                   "'_1st.notes.json' for the A heads, '.post.npz')")
    e.add_argument("--out", help="also write the JSON here")
    e.set_defaults(fn=cmd_evaluate)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
