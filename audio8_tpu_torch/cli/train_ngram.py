"""Estimate an n-gram LM from transcripts to ARPA (the JAX package's
``a8t-train-ngram``): interpolated modified Kneser-Ney
(``ops/ngram.py``), read by ``--lm`` of the port's beam search.

  python -m audio8_tpu_torch.cli.train_ngram --input train.wrd \\
      --output lm.arpa --order 3
  python -m audio8_tpu_torch.cli.test ... --beam 8 --lm lm.arpa
"""
from __future__ import annotations

import logging
from argparse import ArgumentParser

from audio8_tpu_torch.ops.ngram import read_sentences, train_kneser_ney

logger = logging.getLogger("audio8_tpu_torch.train_ngram")


def parse_args(argv=None):
    p = ArgumentParser(description=__doc__)
    p.add_argument("--input", nargs="+", required=True,
                   help="transcript file(s): whitespace-separated words, "
                        "one utterance per line (.wrd format)")
    p.add_argument("--output", required=True, help="ARPA file to write")
    p.add_argument("--order", type=int, default=3)
    p.add_argument("--lowercase", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    args = parse_args(argv)
    if args.order < 1:
        raise ValueError(f"--order must be >= 1, got {args.order}")
    lm = train_kneser_ney(
        read_sentences(args.input, lowercase=args.lowercase), args.order)
    lm.write_arpa(args.output)
    sizes = {}
    for g in lm.prob:
        sizes[len(g)] = sizes.get(len(g), 0) + 1
    logger.info("wrote %s: %s", args.output,
                ", ".join(f"{sizes[k]} {k}-grams" for k in sorted(sizes)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
