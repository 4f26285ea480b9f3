"""Command-line interface of the PyTorch / CUDA port: ``transcribe``.

WAV -> posteriors -> note events -> MIDI (+ JSON), as
``python -m nylon_amt_tpu.cli transcribe`` does:

    python -m nylon_amt_tpu_torch.cli transcribe --checkpoint model.dat \\
        --config config.json --wav piece.wav --out out/ --device cuda

``--checkpoint`` is a reference-format ``.dat`` (a ``torch.save`` dict with
``model_dict``) or a bare ``state_dict`` with the reference's key names.
Writes ``<stem>.mid``, ``<stem>.notes.json`` and one
``<stem>_{1st,2nd}.notes.json`` per head family.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from nylon_amt_tpu.config import Config
from nylon_amt_tpu.midi.smf import write_notes
from nylon_amt_tpu_torch.infer.transcribe import Transcriber
from nylon_amt_tpu_torch.models.hft import HFT


def load_model(path: str, config: Config, device: torch.device | str) -> HFT:
    """Reference ``.dat`` / bare ``state_dict`` -> :class:`HFT` on
    ``device`` (strict key match)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj["model_dict"] if isinstance(obj, dict) and "model_dict" in obj \
        else obj
    model = HFT(config, device)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def cmd_transcribe(args) -> int:
    config = Config.load(args.config) if args.config else Config()
    model = load_model(args.checkpoint, config, args.device)
    tr = Transcriber(config, model, args.device,
                     batch_windows=args.batch_windows)
    # Head families, reference naming: stage-1 "A" heads -> _1st, stage-2
    # "B" heads -> _2nd; single mode emits only _1st.
    families = ([("1st", "A"), ("2nd", "B")] if args.mode == "combination"
                else [("1st", "A")])
    for wav in args.wav:
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
        print(f"{wav}: {len(notes)} notes -> {out_dir}/{stem}.mid")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nylon_amt_tpu_torch",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("transcribe", help="WAV -> MIDI")
    r.add_argument("--config", help="config JSON (default: Config())")
    r.add_argument("--checkpoint", required=True,
                   help="reference .dat or state_dict file")
    r.add_argument("--wav", nargs="+", required=True)
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
    r.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the kernels, cpu the plain "
                   "versions")
    r.set_defaults(fn=cmd_transcribe)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
