"""Command-line interface of the PyTorch / CUDA port: ``corpus``,
``train``, ``transcribe``, ``serve`` and ``evaluate``.

``corpus``: WAV+MIDI pairs -> log-mel features (K1 on ``--device cuda``,
the plain version on ``--device cpu``), frame labels and windowable split
arrays, as ``python -m nylon_amt_tpu.cli corpus`` writes them:

    python -m nylon_amt_tpu_torch.cli corpus --lists lists/ --out corpus/ \
        --refs --device cuda

The pairs come from ``--lists DIR`` (``{split}.tsv``), ``--maestro-csv`` or
``--maps-root``; ``--per-file`` writes one ``per_file/<name>.npz`` a piece
instead of split arrays, ``--refs`` the mir_eval reference texts of the
valid and test pieces under ``ref/``.

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
``--init-from`` warm-starts a fresh run (step 0, fresh Adam and scheduler)
from a run's ``checkpoints/`` (its best checkpoint, or ``--init-epoch /
--init-div``) or a ``.dat``; ``--resume`` / ``--resume-auto`` restore a run
whole. SIGTERM or SIGUSR1 checkpoint the run at the next batch boundary
and end it; ``--resume-auto`` re-runs the interrupted shard.
``--valid-test`` records the test-split loss every (epoch, div),
``--test-metrics`` writes ``test_performance.json`` after training and
``--trace DIR`` writes a ``torch.profiler`` trace of the run.

``transcribe``: WAV -> posteriors -> note events -> MIDI (+ JSON), as
``python -m nylon_amt_tpu.cli transcribe`` does:

    python -m nylon_amt_tpu_torch.cli transcribe --checkpoint model.dat \\
        --config config.json --wav piece.wav --out out/ --device cuda

``--checkpoint`` is a run's ``checkpoints/`` directory (its best
checkpoint, or ``--epoch / --div``), a reference-format ``.dat`` (a
``torch.save`` dict with ``model_dict``) or a bare ``state_dict`` with the
reference's key names.
Writes ``<stem>.mid``, ``<stem>.notes.json`` and one
``<stem>_{1st,2nd}.notes.json`` per head family; ``--tab`` adds
``<stem>.alphatex`` (``--tab-head``: its strings from a tab-head model's
``string_B``), ``--sheet`` ``<stem>.musicxml`` and
``--save-posteriors`` ``<stem>.post.npz``. ``--list DIR --split S``
transcribes every WAV of a lists directory's split; ``--int8`` runs the
W8A8 layers.

``serve``: streaming transcription, one JSON line a note as soon as it is
stable, from s16le PCM on stdin or a stream simulated from a WAV
(``infer/stream.py``; K1 featurizes each emitted block's segment on the
card):

    python -m nylon_amt_tpu_torch.cli serve --checkpoint model.dat \
        --config config.json --wav piece.wav --midi out.mid --device cuda

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


def load_model(path: str, config: Config, device: torch.device | str,
               epoch: int | None = None, div: int | None = None):
    """A checkpoint (:func:`~nylon_amt_tpu_torch.train.checkpoint.
    load_params`: a run's ``checkpoints/``, a ``.dat`` or a bare
    ``state_dict``) -> the config's model (:func:`build_model`) on
    ``device`` (strict key match)."""
    from nylon_amt_tpu_torch.train.checkpoint import load_params

    model = build_model(config, device)
    model.load_state_dict(load_params(path, epoch, div), strict=True)
    return model.eval()


def _load_config(path: str | None) -> Config:
    return Config.load(path) if path else Config()


def cmd_corpus(args) -> int:
    from nylon_amt_tpu_torch.data.corpus import (build_corpus_split,
                                                 write_manifest)
    from nylon_amt_tpu_torch.data.lists import (CorpusList, make_list_maestro,
                                                make_list_maps)
    from nylon_amt_tpu_torch.labels import midi2note, note2label
    from nylon_amt_tpu_torch.labels.note2ref import write_note_refs
    from nylon_amt_tpu_torch.ops.mel import MelFrontend
    from nylon_amt_tpu_torch.utils.wavio import load_mono

    config = _load_config(args.config)
    if args.maestro_csv:
        cl = make_list_maestro(args.maestro_csv, args.root or
                               os.path.dirname(args.maestro_csv))
    elif args.maps_root:
        cl = make_list_maps(args.maps_root)
    else:
        cl = CorpusList.load(args.lists)
    os.makedirs(args.out, exist_ok=True)
    cl.save(os.path.join(args.out, "lists"))

    frontend = MelFrontend(config.feature, args.device)
    n_div = {"train": args.n_div_train, "valid": args.n_div_valid,
             "test": args.n_div_test}
    for split in ("train", "valid", "test"):
        entries = cl.entries[split]
        if args.limit:
            entries = entries[: args.limit]
        pieces = []
        for name, wav_path, midi_path in entries:
            print(f"[{split}] {name}: {wav_path}", file=sys.stderr)
            feat = frontend(load_mono(wav_path, config.feature.sr)
                            ).cpu().numpy()
            notes = midi2note(config, midi_path)
            labels = note2label(config, notes,
                                offset_duration_tolerance_flag=args
                                .offset_duration_tolerance)
            if args.per_file:
                d = os.path.join(args.out, "per_file")
                os.makedirs(d, exist_ok=True)
                np.savez_compressed(os.path.join(d, name + ".npz"),
                                    feature=feat, **labels)
            if args.refs and split in ("valid", "test"):
                # the reference's conv_note2ref.py texts, for the valid and
                # test splits only (EXE-CORPUS-MAESTRO.sh:43-45)
                d = os.path.join(args.out, "ref")
                os.makedirs(d, exist_ok=True)
                write_note_refs(notes, os.path.join(d, name))
            pieces.append((feat, labels))
        if pieces and not args.per_file:
            build_corpus_split(config, pieces, args.out, split,
                               n_div=n_div[split])
    write_manifest(config, args.out)
    print(f"corpus written to {args.out}")
    return 0


def warm_start(config: Config, path: str, epoch: int | None,
               div: int | None, device):
    """``--init-from``: a fresh train state (step 0, fresh Adam) with the
    parameters of the checkpoint at ``path`` (:func:`~nylon_amt_tpu_torch.
    train.checkpoint.load_params`), those it lacks at their fresh
    initialisation; a checkpoint of another architecture ends the run."""
    from nylon_amt_tpu_torch.train.checkpoint import load_params, merge_params
    from nylon_amt_tpu_torch.train.step import create_train_state

    state = create_train_state(config, config.train.seed, device)
    loaded = load_params(path, epoch, div)
    try:
        merged = merge_params(state.model.state_dict(), loaded)
    except (KeyError, ValueError) as e:
        raise SystemExit(f"--init-from {path}: parameter tree does "
                         f"not match this config's architecture ({e})")
    state.model.load_state_dict(merged)
    return state


def cmd_train(args) -> int:
    import contextlib

    from nylon_amt_tpu_torch.data.corpus import SplitArrays
    from nylon_amt_tpu_torch.data.windows import WindowDataset
    from nylon_amt_tpu_torch.train.loop import Trainer

    config = _load_config(args.config)
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

    metrics_fn = None
    if args.test_metrics:
        from nylon_amt_tpu_torch.train.metrics import make_note_metrics_fn

        metrics_fn = make_note_metrics_fn(config)
    state = (warm_start(config, args.init_from, args.init_epoch,
                        args.init_div, args.device)
             if args.init_from else None)
    trainer = Trainer(config, args.out, device=args.device)
    resume = ("auto" if args.resume_auto
              else tuple(args.resume) if args.resume else None)
    ctx = contextlib.nullcontext()
    if args.trace:
        from nylon_amt_tpu_torch.utils.profiling import trace

        ctx = trace(args.trace)
    with ctx:
        trainer.fit(provider, state=state, resume=resume,
                    metrics_fn=metrics_fn, valid_test=args.valid_test)
    print(f"training done; best valid loss {trainer.best_loss_valid:.5f} "
          f"(epoch {trainer.best_epoch} div {trainer.best_div})")
    return 0


def cmd_transcribe(args) -> int:
    config = _load_config(args.config)
    model = load_model(args.checkpoint, config, args.device, args.epoch,
                       args.div)
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
            from nylon_amt_tpu_torch.infer.tab import (annotate_strings,
                                                       write_alphatex)

            tab_notes = notes
            if args.tab_head and "string_B" in post:
                # the learned tab head (ModelConfig.tab_head), opt-in as in
                # the JAX CLI: it has not beaten the lowest-fret rule on the
                # guitar proof corpus (PERF.md); infeasible cells fall back
                # to the greedy assignment inside write_alphatex
                tab_notes = annotate_strings(notes, post["string_B"], config)
            write_alphatex(tab_notes,
                           os.path.join(out_dir, stem + ".alphatex"),
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


def cmd_serve(args) -> int:
    """Streaming transcription: s16le PCM at the config's sample rate on
    stdin (or a stream simulated from ``--wav``) fed to a
    :class:`~nylon_amt_tpu_torch.infer.stream.StreamingTranscriber` in
    ``--chunk-ms`` chunks; each note is printed as one JSON line as soon as
    it is stable (it cannot change with more audio). A final flush emits
    the tail; ``--midi`` also writes the whole result as a MIDI file."""
    from nylon_amt_tpu_torch.infer.stream import StreamingTranscriber

    config = _load_config(args.config)
    model = load_model(args.checkpoint, config, args.device, args.epoch,
                       args.div)
    st = StreamingTranscriber(config, model, args.device,
                              batch_windows=args.batch_windows)
    sr = config.feature.sr
    chunk = max(1, int(sr * args.chunk_ms / 1000))
    all_notes: list[dict] = []

    def emit(notes) -> None:
        for n in notes:
            all_notes.append(n)
            print(json.dumps(n), flush=True)

    # pop_stable_notes decodes a bounded tail and prunes consumed
    # posteriors, so the service runs in bounded memory on endless streams
    if args.wav:
        from nylon_amt_tpu_torch.utils.wavio import load_mono

        wav = load_mono(args.wav, sr)
        for i in range(0, wav.shape[0], chunk):
            if st.feed(wav[i: i + chunk]):
                emit(st.pop_stable_notes())
    else:
        while True:
            data = sys.stdin.buffer.read(chunk * 2)
            if not data:
                break
            samples = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
            if st.feed(samples):
                emit(st.pop_stable_notes())
    st.flush()
    emit(st.pop_stable_notes(final=True))
    if args.midi:
        write_notes(args.midi, sorted(
            sorted(all_notes, key=lambda x: x["pitch"]),
            key=lambda x: x["onset"]))
    print(f"# {len(all_notes)} notes, latency {st.latency_seconds:.2f}s",
          file=sys.stderr)
    return 0


def cmd_evaluate(args) -> int:
    from nylon_amt_tpu_torch.labels import midi2note
    from nylon_amt_tpu_torch.metrics.harness import (
        aggregate,
        score_frames,
        score_mpe_posteriors,
        score_notes,
    )

    config = _load_config(args.config)
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
    c = sub.add_parser("corpus", help="build a windowable training corpus")
    c.add_argument("--config", help="config JSON (default: Config())")
    c.add_argument("--maestro-csv", help="maestro-v3.0.0.csv path")
    c.add_argument("--maps-root", help="MAPS dataset root")
    c.add_argument("--lists", help="directory with {split}.tsv lists")
    c.add_argument("--root", help="dataset root for relative csv paths")
    c.add_argument("--out", required=True)
    c.add_argument("--n-div-train", type=int, default=1)
    c.add_argument("--n-div-valid", type=int, default=1)
    c.add_argument("--n-div-test", type=int, default=1)
    c.add_argument("--limit", type=int, help="first N files per split")
    c.add_argument("--offset-duration-tolerance", action="store_true")
    c.add_argument("--per-file", action="store_true",
                   help="write per-piece archives instead of split arrays")
    c.add_argument("--refs", action="store_true",
                   help="also write mir_eval reference txts for valid/test "
                   "(conv_note2ref.py equivalents) under OUT/ref/")
    c.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the log-mel kernel, cpu "
                   "its plain version")
    c.set_defaults(fn=cmd_corpus)
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
                              "disk (crash / preemption recovery)")
    t.add_argument("--init-from",
                   help="warm-start (fine-tune) from pretrained params: a "
                   "run's checkpoints/ dir or a reference .dat. Fresh "
                   "optimizer / scheduler / epoch counters, unlike --resume, "
                   "which restores the full training state")
    t.add_argument("--init-epoch", type=int,
                   help="with --init-from DIR: pick this (epoch, div)")
    t.add_argument("--init-div", type=int)
    t.add_argument("--trace",
                   help="write a torch.profiler trace of the run to this "
                   "dir (trace.json, Perfetto); for short profiling runs")
    t.add_argument("--test-metrics", action="store_true",
                   help="run the final test pass with note P/R/F1")
    t.add_argument("--valid-test", action="store_true",
                   help="also compute the test-split loss every (epoch, div) "
                   "(reference -valid_test)")
    t.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the kernels, cpu the plain "
                   "versions")
    t.set_defaults(fn=cmd_train)
    r = sub.add_parser("transcribe", help="WAV -> MIDI")
    r.add_argument("--config", help="config JSON (default: Config())")
    r.add_argument("--checkpoint", required=True,
                   help="a run's checkpoints/ dir, or a reference .dat or "
                   "state_dict file")
    r.add_argument("--epoch", type=int,
                   help="with a checkpoints/ dir: this (epoch, div) instead "
                   "of the best")
    r.add_argument("--div", type=int)
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
    r.add_argument("--tab-head", action="store_true",
                   help="with --tab: strings from the learned tab head "
                   "(ModelConfig.tab_head) instead of the default "
                   "lowest-fret rule; experimental (PERF.md)")
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
    v = sub.add_parser("serve", help="streaming transcription (s16le PCM "
                       "on stdin, or a stream simulated from --wav) -> one "
                       "JSON line a note")
    v.add_argument("--config", help="config JSON (default: Config())")
    v.add_argument("--checkpoint", required=True,
                   help="a run's checkpoints/ dir, or a reference .dat or "
                   "state_dict file")
    v.add_argument("--epoch", type=int,
                   help="with a checkpoints/ dir: this (epoch, div) instead "
                   "of the best")
    v.add_argument("--div", type=int)
    v.add_argument("--wav", help="simulate a stream from this WAV (default: "
                   "s16le PCM on stdin)")
    v.add_argument("--chunk-ms", type=float, default=500.0)
    v.add_argument("--batch-windows", type=int, default=1)
    v.add_argument("--midi", help="also write the final MIDI here")
    v.add_argument("--device", default="cuda",
                   help="torch device: cuda runs the kernels, cpu the plain "
                   "versions")
    v.set_defaults(fn=cmd_serve)
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
