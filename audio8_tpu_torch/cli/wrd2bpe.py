"""Re-tokenize ``.wrd`` transcripts to ``.bpe`` with a subword model (the
port's ``a8t-wrd2bpe``, ``audio8_tpu/cli/wrd2bpe.py``, same flags and
output bytes): write ``dict.bpe.txt`` covering the subword vocabulary
into ``--root_dir``, then a ``.bpe`` transcript beside each dataset's
``.wrd`` file.

  python -m audio8_tpu_torch.cli.wrd2bpe --root_dir corpus \\
      --train_dataset train.tsv --valid_dataset valid.tsv \\
      --subword_model_file codes.bpe --subword_vocab_file vocab.bpe
"""
from __future__ import annotations

import os
from argparse import ArgumentParser
from typing import Iterator

from audio8_tpu_torch.models.text import BPEVectorizer
from audio8_tpu_torch.utils import revlut


def retokenize_lines(lines, vec, i2w, lower: bool = False,
                     split: str = " ") -> Iterator[str]:
    """Whitespace-split word lines -> space-joined BPE piece lines."""
    for line in lines:
        text = line.strip()
        if lower:
            text = text.lower()
        pieces = (i2w[piece_id] for piece_id in vec.run(text.split(split)))
        yield " ".join(pieces)


def write_bpe_dict(path: str, i2w) -> None:
    """Dense id -> piece listing; holes in the id space print as
    <unused>."""
    with open(path, "w") as f:
        f.writelines(i2w.get(i, "<unused>") + "\n"
                     for i in range(max(i2w.keys()) + 1))


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--root_dir")
    parser.add_argument("--train_dataset", type=str)
    parser.add_argument("--valid_dataset", type=str)
    parser.add_argument("--subword_model_file", required=True)
    parser.add_argument("--subword_vocab_file", required=True)
    parser.add_argument("--emit_begin_tok", type=str, nargs="*", default=[])
    parser.add_argument("--emit_end_tok", type=str, nargs="*", default=[])
    parser.add_argument("--lower", action="store_true")
    parser.add_argument("--split", type=str, default=" ")
    args = parser.parse_args(argv)

    vec = BPEVectorizer(args.subword_model_file, args.subword_vocab_file,
                        args.emit_begin_tok, args.emit_end_tok)
    i2w = revlut(vec.vocab)
    write_bpe_dict(os.path.join(args.root_dir, "dict.bpe.txt"), i2w)

    for dataset in (args.train_dataset, args.valid_dataset):
        wrd = os.path.join(args.root_dir, dataset).replace(".tsv", ".wrd")
        bpe = wrd.replace(".wrd", ".bpe")
        print(bpe)
        with open(wrd) as rf, open(bpe, "w") as wf:
            for out_line in retokenize_lines(rf, vec, i2w, lower=args.lower,
                                             split=args.split):
                wf.write(out_line + "\n")


if __name__ == "__main__":
    main()
