"""Learn BPE merge codes from ``.wrd`` transcripts (the port's
``a8t-learn-bpe``, ``audio8_tpu/cli/learn_bpe.py``, same flags and
output bytes).

  python -m audio8_tpu_torch.cli.learn_bpe --input train.wrd \\
      --output codes.bpe --num_merges 10000 --write_vocab vocab.bpe

writes the subword-nmt codes file (``models/text.py:learn_bpe``) and,
with ``--write_vocab``, the subword vocabulary observed when the inputs
are segmented with the codes (token and count per line, the
``dict.bpe.txt`` format), which ``cli.wrd2bpe`` and ``--target_type
bpe`` read. It runs on the host only.
"""
from __future__ import annotations

import logging
from argparse import ArgumentParser
from collections import Counter

from audio8_tpu_torch.models.text import SubwordBPE, learn_bpe, write_bpe_codes

logger = logging.getLogger("audio8_tpu_torch.learn_bpe")


def parse_args(argv=None):
    p = ArgumentParser(description=__doc__)
    p.add_argument("--input", nargs="+", required=True,
                   help=".wrd transcript file(s): whitespace-separated "
                        "words, one utterance per line")
    p.add_argument("--output", required=True, help="codes file to write")
    p.add_argument("--num_merges", type=int, default=10_000)
    p.add_argument("--min_frequency", type=int, default=2,
                   help="stop when the best pair is rarer than this "
                        "(subword-nmt default 2)")
    p.add_argument("--write_vocab",
                   help="also write the subword vocabulary (token + "
                        "count per line, dict.bpe.txt format) observed "
                        "when segmenting the inputs with the learned "
                        "codes")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    counts: Counter = Counter()
    for path in args.input:
        with open(path, encoding="utf-8") as f:
            for line in f:
                counts.update(line.split())
    logger.info("word vocab: %d types, %d tokens", len(counts),
                sum(counts.values()))
    merges = learn_bpe(counts, args.num_merges,
                       min_frequency=args.min_frequency)
    write_bpe_codes(args.output, merges)
    logger.info("wrote %d merges to %s", len(merges), args.output)
    if args.write_vocab:
        bpe = SubwordBPE(args.output)
        piece_counts: Counter = Counter()
        for word, c in counts.items():
            for piece in bpe.segment_word(word):
                piece_counts[piece] += c
        with open(args.write_vocab, "w", encoding="utf-8") as f:
            for piece, c in piece_counts.most_common():
                f.write(f"{piece} {c}\n")
        logger.info("wrote %d subword types to %s", len(piece_counts),
                    args.write_vocab)
    return args.output


if __name__ == "__main__":
    main()
