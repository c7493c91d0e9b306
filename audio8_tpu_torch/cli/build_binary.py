"""Compile an ARPA LM into a KenLM binary model (``a8t-build-binary`` of
the JAX package, on the port): the PROBING layout by default, TRIE with
``--trie``, QUANT_TRIE with ``--trie -q``, each byte for byte the JAX
writer's file (``ops/kenlm_bin.py``). ``--lm`` of ``cli.test``,
``cli.transcribe``, ``cli.serve`` and the trainer's verbose validation
reads the result through the host library. Host only: no ``--device``.

  python -m audio8_tpu_torch.cli.train_ngram --input train.wrd \\
      --output lm.arpa --order 3
  python -m audio8_tpu_torch.cli.build_binary lm.arpa lm.bin
  python -m audio8_tpu_torch.cli.build_binary lm.arpa lm.trie --trie -q
  python -m audio8_tpu_torch.cli.test ... --beam 8 --lm lm.bin
"""
from __future__ import annotations

import logging
from argparse import ArgumentParser

from audio8_tpu_torch.ops.kenlm_bin import write_kenlm_binary

logger = logging.getLogger("audio8_tpu_torch.build_binary")


def parse_args(argv=None):
    p = ArgumentParser(description=__doc__)
    p.add_argument("arpa", help="input ARPA file (optionally .gz)")
    p.add_argument("output", help="binary model file to write")
    p.add_argument("-p", "--probing_multiplier", type=float, default=None,
                   help="hash-table space multiplier (kenlm -p; > 1.0; "
                        "probing layout only; default 1.5)")
    p.add_argument("--trie", action="store_true",
                   help="write the sorted bit-packed TRIE layout "
                        "(kenlm `build_binary trie`)")
    p.add_argument("-q", "--quantize", action="store_true",
                   help="with --trie: store probs/backoffs as quantized "
                        "table indices (kenlm `build_binary trie -q`)")
    p.add_argument("--prob_bits", type=int, default=None,
                   help="quantization bits for probabilities (kenlm -q "
                        "N; default 8, requires --quantize)")
    p.add_argument("--backoff_bits", type=int, default=None,
                   help="quantization bits for backoffs (kenlm -b N; "
                        "default 8, requires --quantize)")
    p.add_argument("--no_vocab_strings", action="store_true",
                   help="omit the trailing id-ordered vocabulary strings")
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    args = parse_args(argv)
    # a flag that would be ignored is an error, as in the JAX CLI
    if args.quantize and not args.trie:
        raise ValueError("--quantize requires --trie (kenlm quantizes "
                         "the trie layout only)")
    if not args.quantize and (args.prob_bits is not None or
                              args.backoff_bits is not None):
        raise ValueError("--prob_bits/--backoff_bits only apply with "
                         "--quantize")
    if args.trie and args.probing_multiplier is not None:
        raise ValueError("--probing_multiplier applies to the probing "
                         "layout only")
    multiplier = 1.5 if args.probing_multiplier is None \
        else args.probing_multiplier
    if multiplier <= 1.0:
        raise ValueError("--probing_multiplier must be > 1.0")
    info = write_kenlm_binary(
        args.arpa, args.output, probing_multiplier=multiplier,
        write_vocab_strings=not args.no_vocab_strings,
        search="trie" if args.trie else "probing", quantize=args.quantize,
        prob_bits=8 if args.prob_bits is None else args.prob_bits,
        backoff_bits=8 if args.backoff_bits is None else args.backoff_bits)
    logger.info("wrote %s: %s, order %d, counts %s, %d words", args.output,
                "TRIE -q" if args.quantize else
                ("TRIE" if args.trie else "PROBING"),
                info["order"], info["counts"], info["bound"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
