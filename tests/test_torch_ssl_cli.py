"""HuBERT's and data2vec's entry points end to end on the CPU, against the
JAX package's where both run.

* ``cli.cluster_targets --device cpu`` writes the JAX tool's ``.km``
  files and centroids on the same corpus: from MFCCs (bitwise), and with
  ``--checkpoint`` on the same weights (the HuBERT run's directory for the
  port, a JAX checkpoint directory of the same tree for the JAX tool) at
  ``--feature_layer 1``: the ids equal, the centroids within 1e-4.
  Every ``.km`` line has the clip's conv-grid frame count.
* ``cli.pretrain_hubert`` trains from the ``.km`` files, validates and
  saves at the JAX entry point's steps, resumes a run's directory with its
  AdamW moments and step, and saves on preemption.
* ``cli.pretrain_data2vec`` (``--preset data2vec-base``) saves the
  student and ``teacher-step-N.pt``; a restart from the directory resumes
  both, the teacher bitwise the saved one; without a teacher file the
  teacher is the restored student.
* ``cli.train --restart_from`` a HuBERT or data2vec ``.pt`` fills the CTC
  model's encoder as the JAX ``merge_params`` does: every encoder weight
  from the checkpoint, the CTC head kept, the pretraining heads dropped.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from audio8_tpu_torch.cli import (cluster_targets, pretrain_data2vec,
                                  pretrain_hubert)
from audio8_tpu_torch.config import CONV_FEATURES, conv_output_length
from audio8_tpu_torch.models.convert import load_fairseq_pretrained
from audio8_tpu_torch.train.preempt import PreemptionGuard
from audio8_tpu_torch.utils import Offsets
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.fixture(autouse=True)
def _restore_port_offsets():
    """``cli.train`` remaps the process-global ``Offsets`` to fairseq's
    CTC layout; later tests in this worker want them as they were."""
    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]

SMALL = ["--d_model", "32", "--num_heads", "2", "--num_layers", "2",
         "--d_ff", "64"]
HUBERT = SMALL + ["--num_clusters", "4", "--final_dim", "16",
                  "--warmup_steps", "1", "--valid_steps", "2",
                  "--target_tokens_per_batch", "32000",
                  "--pad_to_multiple", "4000", "--num_train_workers", "1"]
D2V = SMALL + ["--average_top_k_layers", "2", "--warmup_steps", "1",
               "--valid_steps", "1", "--tokens_per_batch", "24000",
               "--max_sample_len", "12000", "--num_train_workers", "1",
               "--preset", "data2vec-base"]
WORDS = ["CAT", "DOG", "GO ON", "HI", "SO SO", "NO WAY"]


def write_manifests(root, audio_dir, lengths):
    for split, ns in lengths.items():
        with open(os.path.join(root, f"{split}.tsv"), "w") as tf, \
                open(os.path.join(root, f"{split}.ltr"), "w") as lf:
            tf.write(str(audio_dir) + "\n")
            for i, n in enumerate(ns):
                tf.write(f"{split}{i}.wav\t{n}\n")
                w = WORDS[i % len(WORDS)]
                lf.write(" ".join(list(w.replace(" ", "|"))) + " |\n")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six training and two validation clips of 0.5-1.1 s, a letter
    dictionary, and manifests in ``port/`` and ``jax/`` over the same
    audio (each tool writes its ``.km`` beside its manifests)."""
    root = tmp_path_factory.mktemp("ssl")
    audio = root / "audio"
    audio.mkdir()
    rng = np.random.default_rng(5)
    lengths = {"train": [8000 + 600 * i for i in range(6)],
               "valid": [8500, 9700]}
    for split, ns in lengths.items():
        for i, n in enumerate(ns):
            wavfile.write(str(audio / f"{split}{i}.wav"), 16000,
                          (rng.normal(size=n) * 5000).astype(np.int16))
    letters = sorted(set("".join(w.replace(" ", "") for w in WORDS)) | {"|"})
    for side in ("port", "jax"):
        (root / side).mkdir()
        write_manifests(root / side, audio, lengths)
        with open(root / side / "dict.ltr.txt", "w") as df:
            df.writelines(f"{ch} 1\n" for ch in letters)
    return root, lengths


def cluster_both(corpus, *extra, port_extra=(), jax_extra=()):
    """The JAX tool and the port's on the two manifest copies; returns
    their (.km lines per split, centroids)."""
    from audio8_tpu.cli.cluster_targets import main as jax_main

    root, lengths = corpus
    args = ["--manifests", "train.tsv", "valid.tsv", "--num_clusters", "4",
            "--fit_frames", "2000", "--kmeans_iters", "5", *extra]
    assert jax_main(["--root_dir", str(root / "jax"), *args,
                     *jax_extra]) == 0
    assert cluster_targets.main(["--root_dir", str(root / "port"), *args,
                                 *port_extra, "--device", "cpu"]) == 0
    out = []
    for side in ("port", "jax"):
        kms = {s: open(root / side / f"{s}.km").read().splitlines()
               for s in lengths}
        out.append((kms, np.load(root / side / "train.centroids.npy")))
    for split, ns in lengths.items():
        for n, line in zip(ns, out[0][0][split]):
            assert len(line.split()) == conv_output_length(
                n, CONV_FEATURES[16])
    return out


def test_cluster_targets_mfcc_match_jax(corpus):
    (ours, c_ours), (theirs, c_theirs) = cluster_both(corpus)
    assert ours == theirs
    assert np.array_equal(c_ours, c_theirs)


@pytest.fixture(scope="module")
def hubert_run(corpus):
    """``cli.pretrain_hubert`` for 3 steps on the MFCC targets."""
    root, _ = corpus
    cluster_both(corpus)
    basedir = str(root / "hubert")
    state = pretrain_hubert.train(HUBERT + [
        "--device", "cpu", "--root_dir", str(root / "port"),
        "--train_dataset", "train.tsv", "--valid_dataset", "valid.tsv",
        "--basedir", basedir, "--train_steps", "3",
        "--steps_per_checkpoint", "3"])
    return state, basedir


def test_pretrain_hubert_trains_validates_saves(hubert_run):
    state, basedir = hubert_run
    assert state.step == 3 and len(state.log) == 3
    assert all(np.isfinite(r["loss"]) and 0.0 <= r["acc_masked"] <= 1.0
               for r in state.log)
    # validate_on = min(train_steps // 2, steps_per_checkpoint) = 1, as JAX
    assert sorted(f for f in os.listdir(basedir) if f.endswith(".pt")) == [
        f"checkpoint-step-{i}.pt" for i in (1, 2, 3)]
    assert set(state.valid) == {"average_valid_loss",
                                "valid_masked_accuracy",
                                "valid_elapsed_epoch"}
    saved = load_fairseq_pretrained(os.path.join(basedir,
                                                 "checkpoint-step-3.pt"))
    for k, v in state.model.state_dict().items():
        assert torch.equal(saved[k], v), k
    assert saved["label_embs_concat"].shape == (4, 16)


def test_pretrain_hubert_resumes_and_saves_on_preemption(hubert_run, corpus,
                                                         tmp_path,
                                                         monkeypatch):
    _, basedir = hubert_run
    root, _ = corpus
    run = str(tmp_path / "resumed")
    shutil.copytree(basedir, run)
    monkeypatch.setattr(PreemptionGuard, "should_save",
                        lambda self, step: step == 5)
    state = pretrain_hubert.train(HUBERT + [
        "--device", "cpu", "--root_dir", str(root / "port"),
        "--train_dataset", "train.tsv", "--valid_dataset", "valid.tsv",
        "--basedir", run, "--train_steps", "40",
        "--steps_per_checkpoint", "100", "--restart_from", run])
    # resumed at 3 with its moments, preempted (and saved) at 5
    assert [r["step"] for r in state.log] == [4, 5]
    assert state.step == 5 and state.opt_state.count == 5
    assert os.path.exists(os.path.join(run, "checkpoint-step-5.pt"))


def test_cluster_targets_from_a_checkpoint_match_jax(hubert_run, corpus,
                                                    tmp_path):
    """Iteration 2 on the HuBERT run's weights, layer 1's output: the port
    reads its ``.pt``, the JAX tool a JAX checkpoint directory of the same
    tree (its own iteration-2 input)."""
    from audio8_tpu.train.checkpoint import save_checkpoint as jax_save

    _, basedir = hubert_run
    ckpt = os.path.join(basedir, "checkpoint-step-3.pt")
    jax_save(_jax_tree_of(load_fairseq_pretrained(ckpt), {}),
             str(tmp_path / "checkpoint"), 3)
    (ours, c_ours), (theirs, c_theirs) = cluster_both(
        corpus, "--feature_layer", "1", *SMALL,
        port_extra=("--checkpoint", basedir),
        jax_extra=("--checkpoint", str(tmp_path)))
    assert ours == theirs
    np.testing.assert_allclose(c_ours, c_theirs, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def d2v_run(corpus):
    root, _ = corpus
    basedir = str(root / "d2v")
    state, teacher = pretrain_data2vec.train(D2V + [
        "--device", "cpu", "--manifest_dir", str(root / "port"),
        "--basedir", basedir, "--train_steps", "2",
        "--steps_per_checkpoint", "2"])
    return state, teacher, basedir


def test_pretrain_data2vec_saves_and_restarts_both(d2v_run, corpus):
    state, teacher, basedir = d2v_run
    root, _ = corpus
    assert state.step == 2 and len(state.log) == 2
    assert all(np.isfinite(r["loss"]) and r["target_std"] > 0
               for r in state.log)
    names = sorted(os.listdir(basedir))
    assert "checkpoint-step-2.pt" in names and "teacher-step-2.pt" in names
    saved = load_fairseq_pretrained(os.path.join(basedir,
                                                 "teacher-step-2.pt"))
    # the teacher moved by the EMA but lags the student
    student = state.model.state_dict()
    key = "post_extract_proj.weight"
    assert not torch.equal(teacher.state_dict()[key], student[key])
    # a restart at the saved step takes no step: both come back as saved
    state2, teacher2 = pretrain_data2vec.train(D2V + [
        "--device", "cpu", "--manifest_dir", str(root / "port"),
        "--basedir", basedir, "--train_steps", "2",
        "--restart_from", basedir])
    assert state2.step == 2 and state2.log == []
    for k, v in teacher2.state_dict().items():
        assert torch.equal(v, saved[k]), k
    for k, v in state2.model.state_dict().items():
        assert torch.equal(v, student[k]), k


def test_data2vec_teacher_is_the_student_without_a_teacher_file(d2v_run,
                                                                tmp_path):
    state, _, basedir = d2v_run
    from audio8_tpu_torch.cli.pretrain_data2vec import make_teacher

    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(os.path.join(basedir, "checkpoint-step-2.pt"), lone)
    teacher = make_teacher(state, str(lone / "checkpoint-step-2.pt"))
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, state.model.state_dict()[k]), k


@pytest.mark.parametrize("source", ["hubert", "data2vec"])
def test_ctc_warm_start_matches_jax_merge(source, hubert_run, d2v_run,
                                          corpus, tmp_path):
    """The JAX merge of a pretraining tree into the CTC model's encoder
    (``merge_params``; the heads dropped) against the port's
    ``cli.train --restart_from`` of the same weights."""
    from audio8_tpu.config import AcousticConfig as JaxAcoustic
    from audio8_tpu.models.convert import merge_params
    from audio8_tpu.models.wav2vec2 import \
        Wav2Vec2AcousticModel as JaxAcousticModel
    from audio8_tpu_torch.cli import train as ctc_train
    from audio8_tpu_torch.models.convert import params_from_jax

    root, _ = corpus
    basedir = hubert_run[1] if source == "hubert" else d2v_run[2]
    ckpt = os.path.join(basedir, "checkpoint-step-2.pt")
    pre = load_fairseq_pretrained(ckpt)
    topo = ({"extractor_mode": "layer", "pos_conv_depth": 5,
             "conv_pos_kernel": 19} if source == "data2vec" else {})
    preset = ["--preset", "data2vec-base"] if source == "data2vec" else []
    state = ctc_train.train(SMALL + preset + [
        "--device", "cpu", "--root_dir", str(root / "port"),
        "--train_dataset", "train.tsv", "--valid_dataset", "valid.tsv",
        "--basedir", str(tmp_path / "ctc"), "--train_steps", "2",
        "--restart_from", ckpt, "--pad_to_multiple", "4000",
        "--target_tokens_per_batch", "40000", "--grad_accum", "1",
        "--warmup_steps", "1", "--num_train_workers", "1",
        "--lr", "0.0"])
    assert state.step == 2 and np.isfinite(state.log[0]["loss"])
    got = state.model.state_dict()
    # JAX: the CTC init with the pretraining tree merged into ``encoder``
    jmodel = JaxAcousticModel(config=JaxAcoustic(
        num_labels=got["proj.weight"].shape[0], d_model=32, num_heads=2,
        num_layers=2, d_ff=64, **topo))
    init = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4000)))["params"])
    dropped: list = []
    merged = merge_params(init["encoder"], _jax_tree_of(pre, topo), dropped)
    assert {d.split("/")[0] for d in dropped} == {"final_proj"} | (
        {"label_embs"} if source == "hubert" else set())
    want = params_from_jax({"encoder": merged, "proj": init["proj"]})
    for k, v in want.items():
        if k.startswith("encoder."):
            assert torch.equal(got[k], v), k
            assert torch.equal(got[k], pre[k[len("encoder."):]]), k


def _jax_tree_of(state: dict, topo: dict) -> dict:
    """A port pretraining state dict as the JAX model's tree (the inverse
    of ``params_from_jax``'s table, its transforms their own inverses)."""
    from audio8_tpu_torch.models.convert import encoder_table

    num_layers = sum(1 for k in state if k.endswith(".fc1.weight"))
    num_fx = sum(1 for k in state if k.startswith(
        "feature_extractor.conv_layers.") and k.endswith(".0.weight"))
    tree: dict = {}

    def put(path, value):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value

    for key, path, tf in encoder_table(topo, num_fx, num_layers):
        put(path, tf(state[key].numpy()))
    put(("final_proj", "kernel"), state["final_proj.weight"].numpy().T)
    put(("final_proj", "bias"), state["final_proj.bias"].numpy())
    if "label_embs_concat" in state:
        put(("label_embs",), state["label_embs_concat"].numpy())
    return tree
