"""Dataset split lists for MAESTRO and MAPS.

The port's copy of ``nylon_amt_tpu/data/lists.py`` (imports aside,
the same code).

Replaces ``corpus/make_list_maestro.py`` (official-CSV split columns, plus
zero-padded canonical names ``{split}_{nnn}``), ``rename_maestro.py``
(canonical symlinks), and ``make_list_maps.py`` (MUS subset;
ENSTDkAm/ENSTDkCl real-piano recordings -> test, overlapping tunes -> valid,
rest -> train — ``make_list_maps.py:48-74``).
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field

SPLITS = ("train", "valid", "test")
_MAESTRO_SPLIT_NAMES = {"train": "train", "validation": "valid", "test": "test"}
MAPS_TEST_PIANOS = ("ENSTDkAm", "ENSTDkCl")


@dataclass
class CorpusList:
    """Canonical name -> (audio path, midi path) per split."""

    entries: dict[str, list[tuple[str, str, str]]] = field(
        default_factory=lambda: {s: [] for s in SPLITS})

    def add(self, split: str, name: str, audio: str, midi: str) -> None:
        self.entries[split].append((name, audio, midi))

    def names(self, split: str) -> list[str]:
        return [n for n, _, _ in self.entries[split]]

    def save(self, out_dir: str) -> None:
        os.makedirs(out_dir, exist_ok=True)
        for split in SPLITS:
            with open(os.path.join(out_dir, f"{split}.list"), "w") as f:
                f.writelines(n + "\n" for n in self.names(split))
            with open(os.path.join(out_dir, f"{split}.tsv"), "w") as f:
                f.writelines(f"{n}\t{a}\t{m}\n"
                             for n, a, m in self.entries[split])

    @classmethod
    def load(cls, out_dir: str) -> "CorpusList":
        cl = cls()
        for split in SPLITS:
            path = os.path.join(out_dir, f"{split}.tsv")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                for line in f:
                    name, audio, midi = line.rstrip("\n").split("\t")
                    cl.add(split, name, audio, midi)
        return cl

    def symlink_canonical(self, wav_dir: str, midi_dir: str) -> None:
        """Create ``wav/{name}.wav`` / ``midi/{name}.mid`` symlinks
        (reference ``rename_maestro.py:18-23``)."""
        os.makedirs(wav_dir, exist_ok=True)
        os.makedirs(midi_dir, exist_ok=True)
        for split in SPLITS:
            for name, audio, midi in self.entries[split]:
                for src, dst in ((audio, os.path.join(wav_dir, name + ".wav")),
                                 (midi, os.path.join(midi_dir, name + ".mid"))):
                    if not os.path.lexists(dst):
                        os.symlink(os.path.abspath(src), dst)


def make_list_maestro(csv_path: str, root: str) -> CorpusList:
    """Parse ``maestro-v3.0.0.csv`` into canonical split lists."""
    cl = CorpusList()
    counters = {s: 0 for s in SPLITS}
    with open(csv_path, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            split = _MAESTRO_SPLIT_NAMES[row["split"]]
            name = f"{split}_{counters[split]:03d}"
            counters[split] += 1
            cl.add(split, name,
                   os.path.join(root, row["audio_filename"]),
                   os.path.join(root, row["midi_filename"]))
    return cl


def make_list_maps(root: str) -> CorpusList:
    """MAPS MUS-subset split (reference ``make_list_maps.py:48-74``):
    real-piano recordings (ENSTDkAm/ENSTDkCl) are test; synthesized
    renditions of tunes that appear in the test set go to valid; the rest
    train."""
    pieces: list[tuple[str, str, str]] = []  # (piano, tune, path-sans-ext)
    for dirpath, _, files in os.walk(root):
        for fname in sorted(files):
            if not fname.endswith(".wav") or "MUS" not in dirpath.split(os.sep)[-1]:
                continue
            stem = fname[:-4]
            # MAPS_MUS-<tune>_<piano>
            try:
                body = stem.split("MAPS_MUS-")[1]
            except IndexError:
                continue
            tune, piano = body.rsplit("_", 1)
            pieces.append((piano, tune, os.path.join(dirpath, stem)))

    test_tunes = {t for p, t, _ in pieces if p in MAPS_TEST_PIANOS}
    cl = CorpusList()
    counters = {s: 0 for s in SPLITS}
    for piano, tune, base in sorted(pieces, key=lambda x: x[2]):
        if piano in MAPS_TEST_PIANOS:
            split = "test"
        elif tune in test_tunes:
            split = "valid"
        else:
            split = "train"
        name = f"{split}_{counters[split]:03d}"
        counters[split] += 1
        cl.add(split, name, base + ".wav", base + ".mid")
    return cl
