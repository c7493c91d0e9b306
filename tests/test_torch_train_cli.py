"""The port's trainer end to end on the CPU: ``cli.train --device cpu``
takes 3 optimizer steps on a tiny synthetic corpus (frozen, then
unfrozen; time masking and dropout on), validates, writes a
fairseq-layout checkpoint, and ``cli.transcribe --device cpu`` reads it
back; with ``--freeze_fx false`` the unfrozen steps train the feature
extractor too; ``--layer_drop``, the topology flags, noise and speed
perturbation, ``--optim sgd`` and ``--remat`` train, and
``--profile_dir`` writes the trace of the steps after the tenth. Flags
of parts not ported yet raise (``--restart_from`` is ported and tested
in ``tests/test_torch_restart.py``)."""
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audio8_tpu_torch.cli import train as train_cli
from audio8_tpu_torch.cli import transcribe
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

SMALL = ["--d_model", "32", "--num_heads", "2", "--num_layers", "1",
         "--d_ff", "64", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _restore_port_offsets():
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]


def write_letter_corpus(root):
    """Six train and six valid clips with letter transcripts under
    ``root``; returns it."""
    audio_dir = root / "audio"
    audio_dir.mkdir()
    rng = np.random.default_rng(0)
    words = ["CAT", "DOG", "GO ON", "HI", "SO SO", "NO WAY"]
    letters = sorted(set("".join(w.replace(" ", "") for w in words)) | {"|"})
    with open(root / "dict.ltr.txt", "w") as df:
        df.writelines(f"{ch} 1\n" for ch in letters)
    for split in ["train", "valid"]:
        with open(root / f"{split}.tsv", "w") as tf, \
                open(root / f"{split}.ltr", "w") as lf:
            tf.write(str(audio_dir) + "\n")
            for i, w in enumerate(words):
                n = 8000 + 2000 * i
                name = f"{split}{i}.wav"
                wavfile.write(str(audio_dir / name), 16000,
                              (rng.normal(size=n) * 5000).astype(np.int16))
                tf.write(f"{name}\t{n}\n")
                lf.write(" ".join(list(w.replace(" ", "|"))) + " |\n")
    return root


@pytest.fixture
def corpus(tmp_path):
    return write_letter_corpus(tmp_path)


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


def test_unfrozen_extractor_trains(corpus, tmp_path):
    """``--freeze_fx false``: the extractor's weights (the k3s2 layer's
    through the conv backward's plain dgrad and wgrad) move once the
    encoder unfreezes, and not before."""
    seen = {}

    def fx_weights(model):
        return {k: v.detach().clone() for k, v in model.state_dict().items()
                if "feature_extractor.conv_layers" in k}

    real_save = train_cli.save_checkpoint

    def keep_weights(state, path, kind):
        seen[os.path.basename(path)] = fx_weights(state.model)
        return real_save(state, path, kind)

    args = _train_args(corpus, str(tmp_path / "run"))
    args[args.index("--train_steps") + 1] = "2"
    args[args.index("--unfreeze_enc_after_step") + 1] = "0"
    train_cli.save_checkpoint = keep_weights  # saved after every step
    try:
        state = train_cli.train(args + ["--freeze_fx", "false"])
    finally:
        train_cli.save_checkpoint = real_save
    assert [r["frozen"] for r in state.log] == [True, False]
    assert all(np.isfinite(r["loss"]) for r in state.log)
    frozen, unfrozen = seen["checkpoint-step-1.pt"], seen["checkpoint-step-2.pt"]
    initial = fx_weights(train_cli.Wav2Vec2AcousticModel(
        state.model.config, generator=torch.Generator().manual_seed(0)))
    for k in initial:  # block 0's conv and GroupNorm, the k3s2 conv
        assert torch.equal(initial[k], frozen[k]), k
        assert not torch.equal(frozen[k], unfrozen[k]), k


@pytest.mark.parametrize("flag", [["--tensor_parallel", "2", "--zero1",
                                   "true"],
                                  # --zero1 runs, pipeline parallelism
                                  # beside it does not
                                  ["--distributed", "true", "--zero1",
                                   "true", "--pipeline_parallel", "2"]])
def test_unported_flags_raise(corpus, tmp_path, flag):
    with pytest.raises(NotImplementedError):
        train_cli.train(_train_args(corpus, str(tmp_path / "r")) + flag)


@pytest.mark.parametrize("flag", [["--noise_manifest", "{noise}"],
                                  ["--speed_perturb", "0.9", "1.1"],
                                  ["--optim", "sgd"],
                                  ["--remat", "true"]])
def test_trainer_flags_train(corpus, tmp_path, flag):
    """The flags that raised before they were ported (noise and speed
    perturbation, SGD, remat) train: augmented batches, an SGD state,
    each layer recomputed (their values against JAX:
    ``test_torch_augment.py``, ``test_torch_sgd.py``,
    ``test_torch_remat.py``)."""
    from audio8_tpu_torch.train.optim import SGDState

    noise = tmp_path / "noise"
    noise.mkdir()
    wavfile.write(str(noise / "n.wav"), 16000,
                  (np.random.default_rng(1).normal(size=3000) * 2000)
                  .astype(np.int16))
    flag = [f.replace("{noise}", str(noise)) for f in flag]
    state = train_cli.train(_train_args(corpus, str(tmp_path / "r")) + flag)
    assert state.step == 3 and all(np.isfinite(r["loss"])
                                   for r in state.log)
    assert isinstance(state.opt_state, SGDState) == (flag[0] == "--optim")
    assert state.model.config.remat == (flag[0] == "--remat")


def test_profile_dir_traces_steps_11_to_15(corpus, tmp_path):
    """``--profile_dir``: the window opens after step 10, and the trace of
    the steps after it is written when the run ends (step 12)."""
    import json

    args = _train_args(corpus, str(tmp_path / "r"))
    for k, v in (("--train_steps", "12"), ("--grad_accum", "1"),
                 ("--steps_per_checkpoint", "100")):
        args[args.index(k) + 1] = v
    state = train_cli.train(args + ["--profile_dir", str(tmp_path / "p")])
    assert os.listdir(tmp_path / "p") == ["trace-steps-10-15.json"]
    with open(state.profile_trace) as f:
        events = json.load(f)["traceEvents"]
    # steps 11 and 12, then the loop's tail up to ``close()``
    assert {e["name"] for e in events if e.get("name", "").startswith(
        "ProfilerStep#")} == {"ProfilerStep#0", "ProfilerStep#1",
                              "ProfilerStep#2"}


@pytest.mark.parametrize("flag", [["--layer_drop", "0.5"],
                                  ["--extractor_mode", "layer",
                                   "--pre_norm", "true"]])
def test_ported_flags_train(corpus, tmp_path, flag):
    """Flags that raised before the topologies and LayerDrop were ported
    train (their values against JAX: ``test_torch_topologies.py`` and
    ``test_torch_layer_drop.py``)."""
    state = train_cli.train(_train_args(corpus, str(tmp_path / "r")) + flag)
    assert state.step == 3
    assert all(np.isfinite(r["loss"]) for r in state.log)
