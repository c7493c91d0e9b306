"""The port's ``cli.test`` and ``cli.train`` against the JAX package's on
one checkpoint, on the CPU.

* A CTC ``.pt`` saved by the port's trainer gives the same greedy WER and
  CER in JAX's ``cli/test.py:evaluate`` and in the port's, on a valid set
  of FLAC files, and the same beam+LM WER at ``--beam 8`` with the ARPA
  text of ``tests/test_beam_differential.py`` (``werr_lm_8``); without an
  LM the beam key is ``werr_8`` in both. KenLM binaries written by the
  port's ``cli.build_binary`` (PROBING, TRIE, QUANT_TRIE) give the ARPA
  run's beam transcripts.
* Both trainers, restarted from that ``.pt`` on one tiny corpus with
  dropout and masking off (``--grad_accum 1``, two frozen steps, then
  unfrozen), log the same per-step losses within the trajectory
  tolerances: rtol 1e-3, the first step 1e-4. JAX's losses are recorded
  by wrapping its ``make_ctc_steps``.
"""
import numpy as np
import pytest
import torch

import audio8_tpu.cli.train as jax_train_cli
from audio8_tpu.cli.test import evaluate as jax_evaluate
from audio8_tpu_torch.cli import test as test_cli
from audio8_tpu_torch.cli import train as train_cli
from audio8_tpu_torch.train.checkpoint import find_latest_checkpoint
from audio8_tpu_torch.utils import Offsets

from tests.test_beam_differential import ARPA
from tests.test_native import encode_flac
from tests.test_torch_train_cli import SMALL, _train_args, corpus  # noqa
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

MODEL = [a for a in SMALL if a not in ("--device", "cpu")] + [
    "--pad_to_multiple", "4000"]


@pytest.fixture(autouse=True)
def _restore_port_offsets():
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]


@pytest.fixture
def flac_corpus(corpus):
    """The train CLI corpus plus a FLAC copy of its valid set."""
    from scipy.io import wavfile

    lines = (corpus / "valid.tsv").read_text().splitlines()
    out = [lines[0]]
    for line in lines[1:]:
        name, n = line.split("\t")
        _, data = wavfile.read(f"{lines[0]}/{name}")
        flac = name.replace(".wav", ".flac")
        with open(f"{lines[0]}/{flac}", "wb") as f:
            f.write(encode_flac(data))
        out.append(f"{flac}\t{n}")
    (corpus / "valid_flac.tsv").write_text("\n".join(out) + "\n")
    (corpus / "valid_flac.ltr").write_text((corpus / "valid.ltr").read_text())
    (corpus / "lm.arpa").write_text(ARPA)
    return corpus


@pytest.fixture
def checkpoint(flac_corpus, tmp_path):
    basedir = str(tmp_path / "run")
    args = _train_args(flac_corpus, basedir)
    args[args.index("--train_steps") + 1] = "2"
    args[args.index("--steps_per_checkpoint") + 1] = "2"
    train_cli.train(args)
    return find_latest_checkpoint(basedir)[0]


@pytest.mark.parametrize("decode", [[], ["--beam", "8"],
                                    ["--beam", "8", "--lm", "lm.arpa"]])
def test_cli_test_scores_a_port_checkpoint_as_jax_does(flac_corpus,
                                                       checkpoint, decode):
    decode = [str(flac_corpus / a) if a == "lm.arpa" else a for a in decode]
    common = MODEL + ["--checkpoint", checkpoint, "--root_dir",
                      str(flac_corpus), "--valid_dataset", "valid_flac.tsv",
                      "--target_tokens_per_batch", "40000", *decode]
    ours = test_cli.evaluate(common + ["--device", "cpu"])
    theirs = jax_evaluate(common + ["--lane_align", "false"])
    keys = set(theirs)
    assert keys == {"cer", "wer", "step"} | (
        {"werr_lm_8" if "--lm" in decode else "werr_8"} if decode else set())
    assert {k: ours[k] for k in keys} == theirs
    assert ours["audio_seconds"] == pytest.approx(
        sum(8000 + 2000 * i for i in range(6)) / 16000)


@pytest.mark.parametrize("layout", [[], ["--trie"], ["--trie", "-q"]])
def test_cli_test_decodes_with_the_ports_binary_lm(flac_corpus, checkpoint,
                                                   layout):
    """``cli.build_binary``'s PROBING and TRIE files give ``cli.test``'s
    beam+LM the ARPA run's transcripts and WER; QUANT_TRIE decodes (8-bit
    tables hold the few values of this LM exactly). Each run reports its
    LM's load seconds."""
    from audio8_tpu_torch.cli import build_binary

    lm = str(flac_corpus / "lm.bin")
    assert build_binary.main([str(flac_corpus / "lm.arpa"), lm]
                             + layout) == 0
    common = MODEL + ["--checkpoint", checkpoint, "--root_dir",
                      str(flac_corpus), "--valid_dataset", "valid_flac.tsv",
                      "--target_tokens_per_batch", "40000", "--beam", "8",
                      "--device", "cpu"]
    arpa = test_cli.evaluate(common + ["--lm", str(flac_corpus / "lm.arpa")],
                             keep_outputs=True)
    binary = test_cli.evaluate(common + ["--lm", lm], keep_outputs=True)
    assert [o["beam"] for o in binary["outputs"]] == \
        [o["beam"] for o in arpa["outputs"]]
    assert binary["werr_lm_8"] == arpa["werr_lm_8"]
    assert binary["lm_load_seconds"] >= 0.0 <= arpa["lm_load_seconds"]


def test_both_trainers_restart_from_one_pt(flac_corpus, checkpoint,
                                           tmp_path, monkeypatch):
    recorded = []
    real = jax_train_cli.make_ctc_steps

    def recording(*a, **kw):
        grad_fn, update_fn, eval_fn = real(*a, **kw)
        step = grad_fn.train_step

        def train_step(*args, **kwargs):
            out = step(*args, **kwargs)
            recorded.append(float(out[1]))
            return out

        grad_fn.train_step = train_step
        return grad_fn, update_fn, eval_fn

    monkeypatch.setattr(jax_train_cli, "make_ctc_steps", recording)
    args = _train_args(flac_corpus, "")
    for flag, value in (("--train_steps", "4"), ("--grad_accum", "1"),
                        ("--steps_per_checkpoint", "100"),
                        ("--valid_steps", "0"),
                        ("--unfreeze_enc_after_step", "2"),
                        ("--timestep_masking", "0.0")):
        args[args.index(flag) + 1] = value
    args = [a for a in args if a not in ("--device", "cpu")] + [
        "--restart_from", checkpoint, "--dropout", "0.0",
        "--channel_masking", "0.0"]
    args[args.index("--basedir") + 1] = str(tmp_path / "port")
    state = train_cli.train(args + ["--device", "cpu"])
    args[args.index("--basedir") + 1] = str(tmp_path / "jax")
    jax_train_cli.train(args + ["--lane_align", "false"])
    losses = [r["loss"] for r in state.log]
    assert [r["frozen"] for r in state.log] == [True] * 3 + [False]
    assert len(recorded) == len(losses) == 4
    np.testing.assert_allclose(losses, recorded, rtol=1e-3)
    np.testing.assert_allclose(losses[0], recorded[0], rtol=1e-4)


def test_cli_test_keeps_each_utterances_outputs(flac_corpus, checkpoint):
    """``evaluate(keep_outputs=True)``: one output per utterance scored,
    whose greedy transcripts give the run's WER against the manifest and
    whose log-probs are the model's on that file alone, padded as its
    batch was."""
    from audio8_tpu_torch.cli.common import load_weights
    from audio8_tpu_torch.data.audio import read_audio
    from audio8_tpu_torch.data.datasets import AudioTextLetterDataset
    from audio8_tpu_torch.models.text import TextVectorizer, read_vocab_list
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
    from audio8_tpu_torch.ops.metrics import (edit_distance_plain,
                                              postproc_letters)

    m = test_cli.evaluate(MODEL + [
        "--checkpoint", checkpoint, "--root_dir", str(flac_corpus),
        "--valid_dataset", "valid_flac.tsv", "--target_tokens_per_batch",
        "40000", "--device", "cpu"], keep_outputs=True)
    lines = (flac_corpus / "valid_flac.tsv").read_text().splitlines()[1:]
    refs = dict(zip((line.split("\t")[0] for line in lines),
                    (postproc_letters(t.split()) for t in (
                        flac_corpus / "valid_flac.ltr").read_text()
                     .splitlines())))
    outs = m["outputs"]
    assert m["step"] == 3 and len(outs) == m["utterances"] == len(refs)
    names = [o["file"].rsplit("/", 1)[1] for o in outs]
    assert sorted(names) == sorted(refs)
    errors = sum(edit_distance_plain(o["greedy"].split(), refs[n].split())
                 for o, n in zip(outs, names))
    assert 100 * errors / sum(len(r.split()) for r in refs.values()) \
        == pytest.approx(m["wer"])

    args = test_cli.parse_args(MODEL + ["--checkpoint", checkpoint])
    vocab = read_vocab_list(str(flac_corpus / "dict.ltr.txt"))
    model = Wav2Vec2AcousticModel(test_cli.AcousticConfig(
        num_labels=len(vocab), d_model=args.d_model,
        num_heads=args.num_heads, num_layers=args.num_layers,
        d_ff=args.d_ff, timestep_masking=0.0, channel_masking=0.0,
        **test_cli.encoder_kwargs(args)))
    load_weights(checkpoint, model, ctc=True)
    model.eval()
    # each file alone, padded to its batch's length as cli.test pads it
    dataset = AudioTextLetterDataset(
        str(flac_corpus / "valid_flac.tsv"),
        TextVectorizer({v: i for i, v in enumerate(vocab)}), 40000,
        shuffle=False, is_infinite=False, pad_to_multiple=4000)
    padded_to = {f: plan["t_audio"] for plan in dataset.batch_plans()
                 for f in plan["files"]}
    for o in outs:
        wav, _ = read_audio(o["file"])
        sig = torch.zeros(1, padded_to[o["file"]])
        sig[0, :len(wav)] = torch.from_numpy(wav)
        with torch.no_grad():
            lp, mask = model(sig, torch.tensor([len(wav)]))
        alone = lp[0, :int(mask.sum())].numpy()
        assert o["log_probs"].shape == alone.shape
        np.testing.assert_allclose(o["log_probs"], alone, atol=1e-5)
