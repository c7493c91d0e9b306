"""The port's paired trainer end to end on the CPU: ``cli.pretrain_paired
--device cpu`` trains on a tiny corpus with BPE targets from the port's
``cli.learn_bpe`` and ``cli.wrd2bpe`` (the rpr transformer text tower)
and with word targets (the bag-of-words tower), each tower unfrozen at
its own step and the temperature learned, validates, writes checkpoints
with resume files, and ``--restart_from <basedir>`` resumes the run at
its step with the AdamW state, ``logit_scale`` included;
``--warmstart_text`` loads a text tower's ``.npz`` before the first
step, and ``--remat`` trains. Without ``--device`` it asks for the card;
the unported flags raise naming their ROADMAP.md item.
"""
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audio8_tpu_torch.cli import learn_bpe, wrd2bpe
from audio8_tpu_torch.cli import pretrain_paired as paired_cli
from audio8_tpu_torch.train.checkpoint import load_port_checkpoint
from audio8_tpu_torch.utils import Offsets

from tests.test_torch_train_cli import SMALL, _restore_port_offsets  # noqa: F401
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

WORDS = ["THE CAT", "A DOG RAN", "GO ON", "THE MAT", "SO SO", "NO WAY"]
TEXT = ["--text_d_model", "16", "--text_num_heads", "2", "--text_num_layers",
        "1", "--text_d_ff", "32", "--text_rpr_k", "3", "--output_dim", "8"]


@pytest.fixture
def corpus(tmp_path):
    """Words in ``.wrd``, their dict, and BPE pieces (``.bpe``,
    ``dict.bpe.txt``) from codes the port learned on the train set."""
    Offsets.remap_fairseq_ctc()  # "<s>" and "</s>" among the specials
    audio = tmp_path / "audio"
    audio.mkdir()
    rng = np.random.default_rng(0)
    for split in ("train", "valid"):
        with open(tmp_path / f"{split}.tsv", "w") as tf, \
                open(tmp_path / f"{split}.wrd", "w") as wf:
            tf.write(str(audio) + "\n")
            for i, w in enumerate(WORDS):
                n = 8000 + 1500 * i
                wavfile.write(str(audio / f"{split}{i}.wav"), 16000,
                              (rng.normal(size=n) * 5000).astype(np.int16))
                tf.write(f"{split}{i}.wav\t{n}\n")
                wf.write(w + "\n")
    words = sorted({w for line in WORDS for w in line.split()})
    (tmp_path / "dict.wrd.txt").write_text("".join(f"{w} 1\n" for w in words))
    learn_bpe.main(["--input", str(tmp_path / "train.wrd"), "--output",
                    str(tmp_path / "codes.bpe"), "--num_merges", "6",
                    "--min_frequency", "1", "--write_vocab",
                    str(tmp_path / "vocab.bpe")])
    wrd2bpe.main(["--root_dir", str(tmp_path), "--train_dataset",
                  "train.tsv", "--valid_dataset", "valid.tsv",
                  "--subword_model_file", str(tmp_path / "codes.bpe"),
                  "--subword_vocab_file", str(tmp_path / "vocab.bpe")])
    return tmp_path


def _args(corpus, basedir, steps="3", target="bpe"):
    args = SMALL + TEXT + [
        "--basedir", basedir, "--root_dir", str(corpus),
        "--train_dataset", "train.tsv", "--valid_dataset", "valid.tsv",
        "--pad_to_multiple", "4000", "--target_tokens_per_batch", "60000",
        "--train_steps", steps, "--steps_per_checkpoint", "3",
        "--valid_steps", "0", "--warmup_steps", "2", "--lr", "1e-3",
        "--unfreeze_audio_after_step", "0",
        "--unfreeze_text_after_step", "1", "--init_temp", "0.1",
        "--num_train_workers", "1", "--target_type", target]
    if target == "bpe":
        args += ["--subword_model_file", str(corpus / "codes.bpe"),
                 "--subword_vocab_file", str(corpus / "vocab.bpe")]
    return args


def test_train_save_and_resume_bpe(corpus, tmp_path):
    basedir = str(tmp_path / "run")
    state = paired_cli.train(_args(corpus, basedir))
    log = state.log
    assert state.step == 3 and len(log) == 3
    assert [(r["freeze_audio"], r["freeze_text"]) for r in log] == [
        (True, True), (False, True), (False, False)]
    assert all(np.isfinite(r["loss"]) and 0 <= r["clip_accuracy"] <= 1
               for r in log)
    scale = state.model.loss.logit_scale
    assert abs(float(scale) - np.log(10.0)) > 0  # the temperature trained
    assert len(state.valid) == 3 and np.isfinite(
        state.valid[-1]["average_valid_loss"])
    ckpt = os.path.join(basedir, "checkpoint-step-3.pt")
    saved = load_port_checkpoint(ckpt, "paired")
    assert set(saved) == set(state.model.state_dict())
    assert "loss.logit_scale" in saved

    resumed = paired_cli.train(_args(corpus, basedir, "4")
                               + ["--restart_from", basedir])
    assert resumed.opt_state.count == 4 and len(resumed.log) == 1
    assert resumed.log[0]["step"] == 4
    i = resumed.names.index("loss.logit_scale")
    assert float(resumed.opt_state.nu[i]) > 0  # its moments were restored


def test_train_words_bow(corpus, tmp_path):
    state = paired_cli.train(_args(corpus, str(tmp_path / "bow"), "2", "wrd")
                             + ["--text_encoder_type", "bow",
                                "--learn_temp", "false",
                                "--stacking_layers", "12"])
    assert state.step == 2 and all(np.isfinite(r["loss"]) for r in state.log)
    assert "loss.logit_scale" not in state.names
    assert all(r["logit_scale"] == pytest.approx(10.0) for r in state.log)


def test_default_device_is_the_card(corpus, tmp_path):
    args = [a for a in _args(corpus, str(tmp_path / "r")) if a != "cpu"]
    args.remove("--device")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no usable CUDA device"):
        paired_cli.train(args)


@pytest.mark.parametrize("flag,value,item", [
    ("--distributed", "true", "item 3"),
    ("--zero1", "true", "item 8"),
])
def test_unported_flags_raise(corpus, tmp_path, flag, value, item):
    with pytest.raises(NotImplementedError, match=item):
        paired_cli.train(_args(corpus, str(tmp_path / "r")) + [flag, value])


@pytest.mark.parametrize("flag", [["--warmstart_text", "{npz}"],
                                  ["--remat", "true"]])
def test_trainer_flags_train(corpus, tmp_path, flag):
    """``--warmstart_text`` and ``--remat``, which raised before they were
    ported, train. The warm start loads the whole text tower (written
    from a second init of it) before the first step: with the text tower
    frozen for both steps and no weight decay, its weights after the run
    are the file's."""
    from audio8_tpu_torch.models.warmstart import save_tlm_npz

    npz = str(tmp_path / "tlm.npz")
    args = _args(corpus, str(tmp_path / "r"), "2")
    args[args.index("--unfreeze_text_after_step") + 1] = "5"
    args += ["--weight_decay", "0"]
    if flag[0] == "--warmstart_text":
        vocab, _, _ = paired_cli.datasets(paired_cli.parse_args(args))
        other = paired_cli.build_module(paired_cli.parse_args(args),
                                        len(vocab), torch.float32).model
        other.init_from(torch.Generator().manual_seed(7))
        save_tlm_npz(other.text_encoder, npz)
    state = paired_cli.train(args + [f.replace("{npz}", npz) for f in flag])
    assert state.step == 2 and all(np.isfinite(r["loss"])
                                   for r in state.log)
    if flag[0] == "--remat":
        assert state.model.model.audio_encoder.encoder.config.remat
        return
    report = state.warmstart
    assert report["loaded"] and not report["unexpected"]
    assert not report["missing_in_npz"]
    blob = np.load(npz)
    text = state.model.model.text_encoder
    np.testing.assert_array_equal(text.embeddings.embedding.detach().numpy(),
                                  blob["embeddings/embedding"])
