"""The PyTorch port imports with jax, flax, the JAX package itself,
``safetensors``, ``transformers``, ``tensorstore``, ``orbax`` and
``zstandard`` unavailable (the card's machine has none of them, and the
port keeps its own copies of the host code it needs, reads safetensors
files itself and reads Orbax checkpoints with its own zstd, OCDBT and
zarr readers); no source of the port or of ``chip_smoke.py`` imports any
of them; and the entry points run on the card by default, raising on a
machine without one rather than falling back to the CPU
(``cli.convert_checkpoint``, which runs on the host, keeps ``--device
cuda`` and ``--output_format pt`` as its defaults)."""
import os
import pkgutil
import re
import subprocess
import sys

import pytest

import audio8_tpu_torch
from audio8_tpu_torch.cli import cluster_targets as cluster_cli
from audio8_tpu_torch.cli import embed as embed_cli
from audio8_tpu_torch.cli import export as export_cli
from audio8_tpu_torch.cli import pretrain as pretrain_cli
from audio8_tpu_torch.cli import pretrain_data2vec as data2vec_cli
from audio8_tpu_torch.cli import pretrain_hubert as hubert_cli
from audio8_tpu_torch.cli import pretrain_paired as paired_cli
from audio8_tpu_torch.cli import serve as serve_cli
from audio8_tpu_torch.cli import test as test_cli
from audio8_tpu_torch.cli import train as train_cli
from audio8_tpu_torch.cli import train_lm as train_lm_cli
from audio8_tpu_torch.cli import train_seq2seq as seq2seq_cli
from audio8_tpu_torch.cli import train_transducer as transducer_cli
from audio8_tpu_torch.cli import transcribe
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

PKG_DIR = os.path.dirname(audio8_tpu_torch.__file__)
ROOT = os.path.dirname(PKG_DIR)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="audio8_tpu_torch."))


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    assert "audio8_tpu_torch.cli.serve" in mods
    assert "audio8_tpu_torch.cli.train" in mods
    assert "audio8_tpu_torch.cli.pretrain" in mods
    for new in ("cli.test", "cli.convert_checkpoint", "csrc.native",
                "ops.beam", "ops.lm", "train.checkpoint", "train.preempt",
                "cli.train_seq2seq", "cli.pretrain_paired", "cli.learn_bpe",
                "cli.wrd2bpe", "nn.embeddings", "nn.pooling",
                "models.seq2seq", "models.dual_encoder", "ops.quant",
                "ops.align", "ops.vad", "ops.ngram", "cli.embed",
                "cli.manifest", "cli.train_ngram", "cli.average_checkpoints",
                "cli.inspect_checkpoint", "models.convert_hf",
                "nn.conformer", "export", "cli.export", "ops.samples",
                "ops.kenlm_bin", "cli.build_binary", "models.warmstart",
                "train.profiler", "cli.train_transducer",
                "models.transducer", "ops.transducer", "data.mfcc",
                "models.hubert", "models.data2vec", "cli.cluster_targets",
                "cli.pretrain_hubert", "cli.pretrain_data2vec",
                "parallel", "parallel.sharding", "parallel.zero",
                "train.orbax",
                "train.ocdbt", "train.zarr"):
        assert f"audio8_tpu_torch.{new}" in mods
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['audio8_tpu'] = None\n"
        "sys.modules['safetensors'] = None\n"
        "sys.modules['transformers'] = None\n"
        "for name in ('tensorstore', 'orbax', 'zstandard'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'flax'))\n"
        "               or k == 'audio8_tpu' or k.startswith('audio8_tpu.')\n"
        "               or k.startswith(('safetensors', 'transformers',\n"
        "                                'tensorstore', 'orbax', 'zstandard'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_source_imports_jax():
    """Nor ``safetensors``, ``transformers``, ``tensorstore``, ``orbax``
    or ``zstandard``, which the card's machine lacks too."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG_DIR):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    banned = tuple(f"{kw} {mod}" for kw in ("import", "from")
                   for mod in ("jax", "flax", "safetensors", "transformers",
                               "tensorstore", "orbax", "zstandard"))
    offenders = []
    for path in paths:
        with open(path) as f:
            offenders += [path for line in f
                          if line.strip().startswith(banned)]
    assert offenders == []


def test_chip_smoke_refuses_without_a_card():
    """chip_smoke.py exits non-zero and prints no result on a machine
    without CUDA (this one)."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


_JAX_PACKAGE = re.compile(r"^\s*(import audio8_tpu\b(?!_torch)|"
                          r"from audio8_tpu(\.| import))")


def test_no_source_imports_the_jax_package():
    sources = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG_DIR):
        sources += [os.path.join(dirpath, f) for f in files
                    if f.endswith(".py")]
    offenders = []
    for path in sources:
        with open(path) as f:
            offenders += [f"{path}:{i}" for i, line in enumerate(f, 1)
                          if _JAX_PACKAGE.match(line)]
    assert offenders == []
    assert _JAX_PACKAGE.match("from audio8_tpu.utils import Offsets")
    assert not _JAX_PACKAGE.match("from audio8_tpu_torch.utils import x")


@pytest.fixture
def _restore_port_offsets():
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]


@pytest.mark.parametrize("entry", ["transcribe", "serve", "train",
                                   "pretrain", "test", "train_seq2seq",
                                   "pretrain_paired", "embed", "export",
                                   "train_transducer",
                                   "transcribe --transducer",
                                   "serve --transducer",
                                   "test --transducer",
                                   "export --transducer",
                                   "cluster_targets", "pretrain_hubert",
                                   "pretrain_data2vec", "train_lm"])
def test_default_device_is_cuda_and_raises_without_a_card(
        entry, tmp_path, _restore_port_offsets):
    """This machine has no CUDA card: the default ``--device cuda`` raises
    before any work instead of running on the CPU."""
    assert not __import__("torch").cuda.is_available()
    ckpt, dict_file = str(tmp_path / "none.pt"), str(tmp_path / "d.txt")
    entry, *flag = entry.split()
    rnnt = ["--transducer", "true"] if flag else []
    with pytest.raises(RuntimeError, match="no usable CUDA device"):
        if entry == "train_transducer":
            transducer_cli.train(["--basedir", str(tmp_path / "run"),
                                  "--root_dir", str(tmp_path),
                                  "--train_dataset", "t.tsv",
                                  "--valid_dataset", "v.tsv"])
        elif entry == "transcribe":
            transcribe.main(["--checkpoint", ckpt, "--dict_file", dict_file,
                             "a.wav"] + rnnt)
        elif entry == "serve":
            serve_cli.build_service(serve_cli.parse_args(
                ["--checkpoint", ckpt, "--dict_file", dict_file] + rnnt))
        elif entry == "embed":
            embed_cli.build_embedder(embed_cli.parse_args(
                ["--checkpoint", ckpt, "--root_dir", str(tmp_path)]))
        elif entry == "export":
            export_cli.main(["--checkpoint", ckpt, "--dict_file", dict_file,
                             "--output", str(tmp_path / "art")] + rnnt)
        elif entry == "test":
            test_cli.evaluate(["--checkpoint", ckpt, "--root_dir",
                               str(tmp_path), "--valid_dataset", "v.tsv"]
                              + rnnt)
        elif entry == "pretrain":
            pretrain_cli.train(["--basedir", str(tmp_path / "run"),
                                "--manifest_dir", str(tmp_path)])
        elif entry == "cluster_targets":
            cluster_cli.main(["--root_dir", str(tmp_path), "--manifests",
                              "t.tsv"])
        elif entry == "pretrain_hubert":
            hubert_cli.train(["--basedir", str(tmp_path / "run"),
                              "--root_dir", str(tmp_path),
                              "--train_dataset", "t.tsv",
                              "--valid_dataset", "v.tsv"])
        elif entry == "train_lm":
            train_lm_cli.train(["--basedir", str(tmp_path / "run"),
                                "--text", "t.ltr", "--dict_file",
                                dict_file])
        elif entry == "pretrain_data2vec":
            data2vec_cli.train(["--basedir", str(tmp_path / "run"),
                                "--manifest_dir", str(tmp_path)])
        elif entry in ("train_seq2seq", "pretrain_paired"):
            cli = seq2seq_cli if entry == "train_seq2seq" else paired_cli
            cli.train(["--basedir", str(tmp_path / "run"),
                       "--root_dir", str(tmp_path),
                       "--train_dataset", "t.tsv",
                       "--valid_dataset", "v.tsv"])
        else:
            train_cli.train(["--basedir", str(tmp_path / "run"),
                             "--root_dir", str(tmp_path),
                             "--train_dataset", "t.tsv",
                             "--valid_dataset", "v.tsv"])


def test_convert_checkpoint_defaults():
    """The converter runs on the host, but keeps the entry points'
    ``--device cuda`` default; its output stays the port's ``.pt`` unless
    ``--output_format orbax`` is given."""
    from audio8_tpu_torch.cli import convert_checkpoint

    args = convert_checkpoint.parse_args(["--input", "a.pt", "--output",
                                          "b"])
    assert (args.device, args.output_format, args.format) == (
        "cuda", "pt", "auto")
    args = convert_checkpoint.parse_args(["--input", "a.pt", "--output",
                                          "b", "--output_format", "orbax"])
    assert args.output_format == "orbax"
