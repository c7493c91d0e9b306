"""Build TSV manifests, transcript label files and letter dicts (the
JAX package's ``a8t-manifest``; a host tool, no torch).

- manifest: the root directory on the header line, then
  ``relpath\\tnum_samples`` rows (sample counts from WAV/FLAC headers,
  no decode);
- LibriSpeech labels: ``<spk>-<chap>-<utt>`` stems resolved against the
  ``*.trans.txt`` files -> ``.wrd`` (words) and ``.ltr`` (letters with
  ``|`` word boundaries and a trailing ``|``, fairseq's libri_labels
  format);
- ``--write_dict``: ``dict.ltr.txt`` with count-descending letters.

    python -m audio8_tpu_torch.cli.manifest \\
        --root /data/LibriSpeech/train-clean-100 --output manifests/ \\
        --valid_fraction 0.01 --labels librispeech --write_dict
"""
from __future__ import annotations

import argparse
import collections
import logging
import os
import random
import struct

logger = logging.getLogger("audio8_tpu_torch")

AUDIO_EXTS = (".wav", ".flac")


def wav_num_samples(path: str) -> int:
    """Per-channel sample count from the RIFF header (no data read)."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"not a WAV file: {path}")
        block_align = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError(f"no data chunk in {path}")
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(size)
                block_align = struct.unpack("<H", fmt[12:14])[0]
            elif cid == b"data":
                if not block_align:
                    raise ValueError(f"data chunk before fmt in {path}")
                return size // block_align
            else:
                f.seek(size + (size & 1), os.SEEK_CUR)


def flac_num_samples(path: str) -> int:
    """Total samples from the STREAMINFO metadata block (no decode)."""
    with open(path, "rb") as f:
        if f.read(4) != b"fLaC":
            raise ValueError(f"not a FLAC file: {path}")
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                raise ValueError(f"no STREAMINFO in {path}")
            btype = hdr[0] & 0x7F
            size = int.from_bytes(hdr[1:4], "big")
            block = f.read(size)
            if btype == 0:  # STREAMINFO: total samples = low 36 bits of
                # the 8-byte field at offset 10 (after rate/channels/bps)
                packed = int.from_bytes(block[10:18], "big")
                return packed & ((1 << 36) - 1)
            if hdr[0] & 0x80:  # last-metadata-block flag, no STREAMINFO
                raise ValueError(f"no STREAMINFO in {path}")


def audio_num_samples(path: str) -> int:
    if path.lower().endswith(".flac"):
        return flac_num_samples(path)
    return wav_num_samples(path)


def scan_corpus(root: str, exts=AUDIO_EXTS):
    """Sorted (relpath, num_samples) pairs for every audio file under root."""
    rows = []
    for dirpath, _, names in os.walk(root):
        for name in sorted(names):
            if name.lower().endswith(tuple(exts)):
                full = os.path.join(dirpath, name)
                rel = os.path.relpath(full, root)
                rows.append((rel, audio_num_samples(full)))
    rows.sort()
    return rows


def write_manifest(path: str, root: str, rows) -> None:
    with open(path, "w") as f:
        f.write(os.path.abspath(root) + "\n")
        for rel, n in rows:
            f.write(f"{rel}\t{n}\n")


def load_librispeech_transcripts(root: str) -> dict:
    """utt-id -> text from every ``*.trans.txt`` under root."""
    table = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.endswith(".trans.txt"):
                with open(os.path.join(dirpath, name)) as f:
                    for line in f:
                        utt, _, text = line.strip().partition(" ")
                        if utt:
                            table[utt] = text
    return table


def words_to_ltr(text: str) -> str:
    """fairseq libri_labels format: letters space-separated, ``|`` word
    boundaries, trailing `` |``."""
    return " ".join(list(text.replace(" ", "|"))) + " |"


def write_labels(manifest_rows, transcripts: dict, out_prefix: str):
    """.wrd/.ltr files aligned row-for-row with the manifest; returns
    letter counts for dict building. Rows with no transcript are an
    error (a misaligned label file corrupts training silently)."""
    counts: collections.Counter = collections.Counter()
    missing = []
    with open(out_prefix + ".wrd", "w") as fw, \
            open(out_prefix + ".ltr", "w") as fl:
        for rel, _ in manifest_rows:
            utt = os.path.splitext(os.path.basename(rel))[0]
            text = transcripts.get(utt)
            if text is None:
                missing.append(utt)
                continue
            ltr = words_to_ltr(text)
            fw.write(text + "\n")
            fl.write(ltr + "\n")
            counts.update(ltr.split(" "))
    if missing:
        raise SystemExit(
            f"{len(missing)} manifest rows have no transcript "
            f"(first: {missing[:3]}) — labels would misalign")
    return counts


def write_dict(counts, path: str) -> None:
    with open(path, "w") as f:
        for tok, n in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
            f.write(f"{tok} {n}\n")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="corpus directory")
    ap.add_argument("--output", required=True, help="output directory")
    ap.add_argument("--train_name", default="train")
    ap.add_argument("--valid_name", default="valid")
    ap.add_argument("--valid_fraction", type=float, default=0.0,
                    help=">0: split this fraction of files into "
                         "{valid_name}.tsv (seeded shuffle)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--ext", nargs="+", default=list(AUDIO_EXTS))
    ap.add_argument("--min_samples", type=int, default=0,
                    help="drop clips shorter than this many samples")
    ap.add_argument("--labels", choices=["none", "librispeech"],
                    default="none",
                    help="librispeech: resolve *.trans.txt transcripts "
                         "into .wrd/.ltr files aligned with each manifest")
    ap.add_argument("--write_dict", action="store_true",
                    help="also write dict.ltr.txt (letter counts)")
    args = ap.parse_args(argv)

    rows = scan_corpus(args.root, tuple(e if e.startswith(".") else "." + e
                                        for e in args.ext))
    if args.min_samples:
        before = len(rows)
        rows = [r for r in rows if r[1] >= args.min_samples]
        logger.info("dropped %d clips < %d samples", before - len(rows),
                    args.min_samples)
    if not rows:
        raise SystemExit(f"no audio files under {args.root}")
    logger.info("found %d audio files (%.1f h assuming 16 kHz)", len(rows),
                sum(n for _, n in rows) / 16_000 / 3600)

    os.makedirs(args.output, exist_ok=True)
    splits = {args.train_name: rows}
    if args.valid_fraction > 0:
        shuffled = rows[:]
        random.Random(args.seed).shuffle(shuffled)
        n_valid = max(1, int(len(rows) * args.valid_fraction))
        splits = {args.valid_name: sorted(shuffled[:n_valid]),
                  args.train_name: sorted(shuffled[n_valid:])}

    transcripts = (load_librispeech_transcripts(args.root)
                   if args.labels == "librispeech" else None)
    all_counts: collections.Counter = collections.Counter()
    for name, split_rows in splits.items():
        tsv = os.path.join(args.output, f"{name}.tsv")
        write_manifest(tsv, args.root, split_rows)
        logger.info("wrote %s (%d rows)", tsv, len(split_rows))
        if transcripts is not None:
            counts = write_labels(split_rows, transcripts,
                                  os.path.join(args.output, name))
            all_counts.update(counts)
            logger.info("wrote %s.wrd / %s.ltr", name, name)
    if args.write_dict:
        if not all_counts:
            raise SystemExit("--write_dict needs --labels")
        path = os.path.join(args.output, "dict.ltr.txt")
        write_dict(all_counts, path)
        logger.info("wrote %s (%d tokens)", path, len(all_counts))


if __name__ == "__main__":
    main()
