"""``cli.export --transducer`` of the port end to end on the CPU
(``--device cpu``), on a seeded transducer checkpoint and the letter
corpus of ``test_torch_transducer_cli.py``: the artifact has JAX's three
roles and ``meta`` keys, and ``--exported`` in ``cli.transcribe``,
``cli.serve`` (``/transcribe`` and ``/stream``) and ``cli.test`` gives
the live model's streamer tokens; ``cli.embed`` refuses the artifact and
``cli.export`` more than one ``--seconds``, as JAX's do.
"""
import json
import os

import pytest
import torch
from scipy.io import wavfile

from audio8_tpu_torch.cli import embed as embed_cli
from audio8_tpu_torch.cli import export as export_cli
from audio8_tpu_torch.cli import test as test_cli
from audio8_tpu_torch.cli import transcribe
from audio8_tpu_torch.config import TransducerConfig
from audio8_tpu_torch.models.text import read_vocab_list
from audio8_tpu_torch.models.transducer import Transducer
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_transducer_cli import (MODEL, _restore_port_offsets,
                                             _serve_texts, write_corpus)

cap_torch_threads()
__all__ = ["_restore_port_offsets"]  # the fixture this file uses


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    """The corpus and a transducer ``.pt`` of seeded weights at MODEL's
    sizes: (corpus dir, checkpoint flags)."""
    root = tmp_path_factory.mktemp("corpus")
    write_corpus(root)
    Offsets.remap_fairseq_ctc()
    vocab = read_vocab_list(str(root / "dict.ltr.txt"))
    cfg = TransducerConfig(vocab_size=len(vocab), d_model=32, num_heads=2,
                           num_layers=1, d_ff=64, pred_layers=1,
                           pred_dim=32, pred_embed_dim=16, d_joint=32)
    model = Transducer(cfg, generator=torch.Generator().manual_seed(0))
    path = str(root / "rnnt.pt")
    torch.save({"kind": "transducer", "model": model.state_dict()}, path)
    return root, ["--checkpoint", path, "--dict_file",
                  str(root / "dict.ltr.txt")]


def test_export_and_exported_clis(seeded, tmp_path):
    root, ckpt = seeded
    art = str(tmp_path / "art")
    export_cli.main(MODEL + ckpt + [
        "--transducer", "true", "--platforms", "cpu", "--seconds", "5",
        "--output", art])
    meta = json.load(open(os.path.join(art, "meta.json")))
    assert meta["kind"] == "transducer" and meta["window_frames"] == 256
    assert sorted(e["role"] for e in meta["entries"]) == [
        "decode_frames", "decode_init", "encode"]
    wavs = [str(root / "audio" / f"valid{i}.wav") for i in (0, 5)]
    live = transcribe.main(wavs + MODEL + ckpt + [
        "--transducer", "true", "--chunk_seconds", "5"])
    exported = transcribe.main(wavs + ["--device", "cpu", "--exported", art])
    assert exported == live
    _, wav = wavfile.read(wavs[1])
    text, health = _serve_texts(["--device", "cpu", "--exported", art], wav)
    assert text == live[1][1] and health["d_model"] == 32
    scored = test_cli.evaluate(["--device", "cpu", "--exported", art,
                                "--root_dir", str(root), "--valid_dataset",
                                "valid.tsv", "--pad_to_multiple", "4000"])
    assert scored["utterances"] == 6
    with pytest.raises(SystemExit, match="'transducer' artifact"):
        embed_cli.build_embedder(embed_cli.parse_args(
            ["--root_dir", str(root), "--device", "cpu", "--exported",
             art]))
    with pytest.raises(SystemExit, match="ONE encoder-chunk"):
        export_cli.main(MODEL + ckpt + [
            "--transducer", "true", "--platforms", "cpu", "--seconds", "5",
            "30", "--output", str(tmp_path / "two")])
    with pytest.raises(SystemExit, match="not needed with --exported"):
        transcribe.main(wavs + ["--device", "cpu", "--exported", art,
                                "--transducer", "true"])
