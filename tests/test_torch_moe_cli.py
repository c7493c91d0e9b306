"""The MoE flags through the port's entry points with ``--device cpu`` on
the tiny corpus of ``tests/test_torch_train_cli.py`` (d 64, f 128, 1
layer made an MoE of E 4 by ``--moe_every 1``, top-2, ``--optim sgd``;
64 wide so that ``--quantize int8`` finds Dense kernels at its
``min_dim``):

* ``cli.train`` trains three steps (two frozen, in which the aux alone
  moves the encoder's router) and writes a checkpoint per step whose
  expert leaves ``cli.inspect_checkpoint`` counts and
  ``cli.average_checkpoints`` averages;
* ``cli.test`` scores it and ``cli.transcribe`` decodes it, also under
  ``--quantize int8``;
* ``cli.export`` traces it and ``cli.transcribe --exported`` gives the
  live transcripts.
"""
import os

import numpy as np
import torch

from audio8_tpu_torch.cli import average_checkpoints, inspect_checkpoint
from audio8_tpu_torch.cli import export as export_cli
from audio8_tpu_torch.cli import test as test_cli
from audio8_tpu_torch.cli import train as train_cli
from audio8_tpu_torch.cli import transcribe
from audio8_tpu_torch.models.convert import load_fairseq_ctc
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_train_cli import (SMALL, _restore_port_offsets,  # noqa
                                        _train_args, corpus)

cap_torch_threads()

MOE = ["--moe_experts", "4", "--moe_top_k", "2", "--moe_every", "1",
       "--moe_aux_weight", "0.1", "--moe_capacity_factor", "1.5"]
ROUTER = "encoder.encoder.layers.0.moe.router.weight"
SIZE = ["--d_model", "64", "--num_heads", "2", "--num_layers", "1",
        "--d_ff", "128", "--device", "cpu"]


def test_moe_train_decode_export(corpus, tmp_path):
    basedir = str(tmp_path / "run")
    args = _train_args(corpus, basedir) + MOE + ["--optim", "sgd"]
    args[:len(SMALL)] = SIZE
    args[args.index("--steps_per_checkpoint") + 1] = "1"
    state = train_cli.train(args)
    assert [r["frozen"] for r in state.log] == [True, True, False]
    assert all(np.isfinite(r["loss"]) for r in state.log)
    ckpts = [os.path.join(basedir, f"checkpoint-step-{i}.pt")
             for i in (1, 2, 3)]
    first, second = (load_fairseq_ctc(p) for p in ckpts[:2])
    assert not torch.equal(first[ROUTER], second[ROUTER])  # frozen step
    assert first["encoder.encoder.layers.0.moe.wi"].shape == (4, 64, 128)

    summary = inspect_checkpoint.main([ckpts[-1], "--json"])
    assert "encoder" in json_dump(summary)
    avg = average_checkpoints.main(["--checkpoints", *ckpts[1:],
                                    "--output", str(tmp_path / "avg")])
    blob = torch.load(avg, weights_only=True)["model"]
    wi = "w2v_encoder.w2v_model.encoder.layers.0.moe.wi"
    last = torch.load(ckpts[-1], weights_only=True)["model"]
    prev = torch.load(ckpts[1], weights_only=True)["model"]
    torch.testing.assert_close(blob[wi], (last[wi] + prev[wi]) / 2)

    ckpt = ckpts[-1]
    metrics = test_cli.evaluate(SIZE + MOE + [
        "--checkpoint", ckpt, "--root_dir", str(corpus),
        "--valid_dataset", "valid.tsv", "--target_tokens_per_batch",
        "40000", "--pad_to_multiple", "4000"])
    assert metrics["wer"] >= 0

    dict_file = str(corpus / "dict.ltr.txt")
    wavs = [str(corpus / "audio" / f"valid{i}.wav") for i in (0, 1)]
    live = transcribe.main(["--checkpoint", ckpt, "--dict_file", dict_file,
                            *SIZE, *MOE, *wavs])
    int8 = transcribe.main(["--checkpoint", ckpt, "--dict_file", dict_file,
                            "--quantize", "int8", *SIZE, *MOE, *wavs])
    assert [w for w, _ in int8] == wavs  # the attention's 4 Dense layers
    art = export_cli.main(["--checkpoint", ckpt, "--dict_file", dict_file,
                           "--output", str(tmp_path / "art"), "--seconds",
                           "1", "--platforms", "cpu", *SIZE, *MOE])
    exported = transcribe.main(["--exported", art, "--device", "cpu",
                                *wavs])
    assert exported == live


def json_dump(obj) -> str:
    import json

    return json.dumps(obj, default=str)
