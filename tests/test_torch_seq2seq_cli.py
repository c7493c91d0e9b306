"""The port's seq2seq trainer end to end on the CPU: ``cli.train_seq2seq
--device cpu`` takes 3 optimizer steps of 2 micro-batches on a tiny
letter corpus (frozen, then unfrozen with the extractor; dropout and
masking on), validates greedily and with a beam, writes its checkpoints
and resume files, and ``--restart_from <basedir>`` resumes the run at
its step with the AdamW state. Without ``--device`` it asks for the card
and raises where there is none; flags of parts not ported yet raise.
"""
import os

import numpy as np
import pytest
import torch

from audio8_tpu_torch.cli import train_seq2seq as s2s_cli
from audio8_tpu_torch.train.checkpoint import load_port_checkpoint

from tests.test_torch_train_cli import (SMALL, _restore_port_offsets,  # noqa: F401
                                        corpus)
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()


def _args(corpus, basedir, steps="3"):
    return SMALL + ["--basedir", basedir, "--root_dir", str(corpus),
                    "--train_dataset", "train.tsv",
                    "--valid_dataset", "valid.tsv",
                    "--pad_to_multiple", "4000",
                    "--target_tokens_per_batch", "40000",
                    "--train_steps", steps, "--steps_per_checkpoint", "3",
                    "--valid_steps", "0", "--warmup_steps", "2",
                    "--unfreeze_enc_after_step", "1",
                    "--timestep_masking", "0.1", "--freeze_fx", "false",
                    "--decoder_heads", "2", "--num_train_workers", "1"]


def test_train_save_and_resume(corpus, tmp_path):
    basedir = str(tmp_path / "run")
    state = s2s_cli.train(_args(corpus, basedir) + ["--valid_beam", "2"])
    assert state.step == 3 and len(state.log) == 3
    assert [r["frozen"] for r in state.log] == [True, True, False]
    assert all(np.isfinite(r["loss"]) and r["audio_s"] > 0
               for r in state.log)
    # validate_on = min(3 // 2, 3): every step, with a beam of 2
    assert len(state.valid) == 3 and state.valid[0]["beam"] == 2
    assert all(np.isfinite(v["cer"]) and v["utterances"] > 0
               for v in state.valid)
    ckpt = os.path.join(basedir, "checkpoint-step-3.pt")
    saved = load_port_checkpoint(ckpt, "seq2seq")
    assert set(saved) == set(state.model.state_dict())
    assert os.path.exists(os.path.join(basedir, "checkpoint-step-3.resume"))

    resumed = s2s_cli.train(_args(corpus, basedir, "4")
                            + ["--restart_from", basedir])
    assert resumed.opt_state.count == 4 and len(resumed.log) == 1
    assert resumed.log[0]["step"] == 4 and not resumed.log[0]["frozen"]
    for k, v in saved.items():
        if k.startswith("decoder.") and k.endswith("weight"):
            assert not torch.equal(v, resumed.model.state_dict()[k]), k
            break


def test_seq2seq_checkpoint_warm_starts_at_step_zero(corpus, tmp_path):
    """A seq2seq ``.pt`` named directly loads whole at step 0."""
    basedir = str(tmp_path / "run")
    state = s2s_cli.train(_args(corpus, basedir, "2"))
    ckpt = os.path.join(basedir, "checkpoint-step-1.pt")
    again = s2s_cli.train(_args(corpus, str(tmp_path / "again"), "2")
                          + ["--restart_from", ckpt])
    assert state.step == 2 and again.step == 2 and len(again.log) == 2


def test_default_device_is_the_card(corpus, tmp_path):
    args = [a for a in _args(corpus, str(tmp_path / "r")) if a != "cpu"]
    args.remove("--device")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no usable CUDA device"):
        s2s_cli.train(args)


@pytest.mark.parametrize("flag,value,item", [
    ("--distributed", "true", "item 3"),
    ("--tensor_parallel", "2", "item 8"),
])
def test_unported_flags_raise(corpus, tmp_path, flag, value, item):
    with pytest.raises(NotImplementedError, match=item):
        s2s_cli.train(_args(corpus, str(tmp_path / "r")) + [flag, value])


@pytest.mark.parametrize("flag", [["--speed_perturb", "0.9", "1.1"],
                                  ["--noise_manifest", "{noise}"],
                                  ["--remat", "true"]])
def test_trainer_flags_train(corpus, tmp_path, flag):
    """Speed and noise perturbation and ``--remat``, which raised before
    they were ported, train."""
    from scipy.io import wavfile

    noise = tmp_path / "noise"
    noise.mkdir()
    wavfile.write(str(noise / "n.wav"), 16000,
                  (np.random.default_rng(1).normal(size=3000) * 2000)
                  .astype(np.int16))
    flag = [f.replace("{noise}", str(noise)) for f in flag]
    state = s2s_cli.train(_args(corpus, str(tmp_path / "r"), steps="2")
                          + flag)
    assert state.step == 2
    assert all(np.isfinite(r["loss"]) for r in state.log)
    assert state.model.encoder.config.remat == (flag[0] == "--remat")


def test_layer_drop_trains(corpus, tmp_path):
    """``--layer_drop``, which raised before this slice, trains."""
    state = s2s_cli.train(_args(corpus, str(tmp_path / "r"), steps="2")
                          + ["--layer_drop", "0.5"])
    assert state.step == 2
    assert all(np.isfinite(r["loss"]) for r in state.log)
