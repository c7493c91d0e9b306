"""The port's trainer end to end on the CPU: ``cli.train --device cpu``
takes 3 optimizer steps on a tiny synthetic corpus (frozen, then
unfrozen; time masking and dropout on), validates, writes a
fairseq-layout checkpoint, and ``cli.transcribe --device cpu`` reads it
back. Flags of parts not ported yet raise."""
import os

import numpy as np
import pytest
from scipy.io import wavfile

from audio8_tpu_torch.cli import train as train_cli
from audio8_tpu_torch.cli import transcribe
from audio8_tpu_torch.utils import Offsets

SMALL = ["--d_model", "32", "--num_heads", "2", "--num_layers", "1",
         "--d_ff", "64", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _restore_port_offsets():
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]


@pytest.fixture
def corpus(tmp_path):
    audio_dir = tmp_path / "audio"
    audio_dir.mkdir()
    rng = np.random.default_rng(0)
    words = ["CAT", "DOG", "GO ON", "HI", "SO SO", "NO WAY"]
    letters = sorted(set("".join(w.replace(" ", "") for w in words)) | {"|"})
    with open(tmp_path / "dict.ltr.txt", "w") as df:
        df.writelines(f"{ch} 1\n" for ch in letters)
    for split in ["train", "valid"]:
        with open(tmp_path / f"{split}.tsv", "w") as tf, \
                open(tmp_path / f"{split}.ltr", "w") as lf:
            tf.write(str(audio_dir) + "\n")
            for i, w in enumerate(words):
                n = 8000 + 2000 * i
                name = f"{split}{i}.wav"
                wavfile.write(str(audio_dir / name), 16000,
                              (rng.normal(size=n) * 5000).astype(np.int16))
                tf.write(f"{name}\t{n}\n")
                lf.write(" ".join(list(w.replace(" ", "|"))) + " |\n")
    return tmp_path


def _train_args(corpus, basedir):
    return SMALL + ["--basedir", basedir, "--root_dir", str(corpus),
                    "--train_dataset", "train.tsv",
                    "--valid_dataset", "valid.tsv",
                    "--pad_to_multiple", "4000",
                    "--target_tokens_per_batch", "40000",
                    "--train_steps", "3", "--grad_accum", "2",
                    "--steps_per_checkpoint", "3", "--valid_steps", "2",
                    "--warmup_steps", "2", "--unfreeze_enc_after_step", "1",
                    "--timestep_masking", "0.1", "--num_train_workers", "1"]


def test_train_then_transcribe(corpus, tmp_path):
    basedir = str(tmp_path / "run")
    state = train_cli.train(_train_args(corpus, basedir))
    assert state.step == 3 and len(state.log) == 3
    assert [r["frozen"] for r in state.log] == [True, True, False]
    assert all(np.isfinite(r["loss"]) and r["audio_s"] > 0
               for r in state.log)
    ckpt = os.path.join(basedir, "checkpoint-step-3.pt")
    assert os.path.exists(ckpt), os.listdir(basedir)
    wav = str(corpus / "audio" / "valid0.wav")
    out = transcribe.main(["--checkpoint", ckpt, "--dict_file",
                           str(corpus / "dict.ltr.txt"), *SMALL, wav])
    assert out[0][0] == wav and isinstance(out[0][1], str)


@pytest.mark.parametrize("flag", [["--restart_from", "x.pt"],
                                  ["--speed_perturb", "0.9", "1.1"],
                                  ["--tensor_parallel", "2"],
                                  ["--layer_drop", "0.1"],
                                  ["--optim", "sgd"]])
def test_unported_flags_raise(corpus, tmp_path, flag):
    with pytest.raises(NotImplementedError):
        train_cli.train(_train_args(corpus, str(tmp_path / "r")) + flag)
