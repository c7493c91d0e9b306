"""The port's entry-point flags against the JAX package's parsers.

* Every flag of the JAX ``train``, ``pretrain``, ``train_seq2seq``,
  ``pretrain_paired``, ``train_transducer``, ``train_lm``,
  ``pretrain_hubert``, ``pretrain_data2vec``, ``cluster_targets``,
  ``transcribe``, ``serve``, ``test``, ``learn_bpe``, ``wrd2bpe`` and
  ``convert_checkpoint`` parsers but ``--lane_align`` (ROADMAP.md "Not
  to port") parses in the port's counterpart, with the same default and
  choices (the parsers are captured at ``parse_args`` with no argument
  parsed); ``cli.convert_checkpoint``'s ``--format`` also takes
  ``orbax``, the JAX package's checkpoints as input (``PORT_CHOICES``),
  which the JAX converter writes but does not read.
* A value the port cannot run raises ``NotImplementedError`` naming its
  ROADMAP.md queue item, never an argparse exit. Which values those are
  depends on the entry point: the decoders and the trainer decode with
  ``--beam`` and ``--lm``, ``cli.transcribe`` and ``cli.serve`` take
  ``--timestamps`` and ``--quantize`` (and ``cli.transcribe`` ``--vad``),
  ``cli.test`` ``--quantize``; ``--transducer`` runs in the decoders
  and ``cli.export``, ``--device_beam`` in the three decoders and
  ``--lm_rescore`` in ``cli.test``, where JAX's own refusals hold
  (``--transducer`` takes no ``--device_beam``, ``--lm_rescore`` needs a
  beam); every trainer takes ``--restart_from``.
* The trainers' flags of items 4 and 10 parse, pass ``check_ported`` and
  reach the module that runs them: ``--remat`` the encoder config,
  ``--noise_manifest`` and ``--speed_perturb`` the training set's
  augmentation, ``--optim sgd`` the port's ``SGD``, ``--profile_dir``
  the step profiler, ``--warmstart_text`` the text tower.
* ``--exported`` (item 6, done) loads a ``cli.export`` artifact and
  decodes in ``cli.transcribe``, ``cli.serve``, ``cli.test`` and
  ``cli.embed``. The trainers take
  ``--layer_drop`` and every entry point every topology flag and
  preset, and the MoE flags; expert parallelism (``--moe_experts``
  beside ``--tensor_parallel 2``, item 8) still raises.
* ``--zero1`` and ``--fsdp`` pass in the seven trainers that take them
  in JAX (with ``--distributed`` too) and are inert in the entry points
  where JAX parses and ignores them; tensor, sequence and pipeline
  parallelism still raise naming item 8.
* A value the port can run runs: dropout flags at inference, the LM
  weights without an LM, the MoE and transducer sizes without MoE or a
  transducer, the topology flags at the port's own topology.
"""
import argparse
import importlib

import pytest

from audio8_tpu_torch.cli.common import check_ported, encoder_kwargs
from audio8_tpu_torch.config import AcousticConfig
from audio8_tpu_torch.models.wav2vec2 import check_supported
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.fixture(autouse=True)
def _restore_port_offsets():
    """``cli.test`` remaps the process-global ``Offsets``; put them back."""
    from audio8_tpu_torch.utils import Offsets

    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    yield
    Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
    Offsets.VALUES[:] = saved[4]


ENTRY_POINTS = ("train", "pretrain", "train_seq2seq", "pretrain_paired",
                "transcribe", "serve", "test")
TRAINING_ENTRIES = ENTRY_POINTS[:4]
# the arguments each port entry point needs to parse at all
NEEDED = {"train": [], "pretrain": ["--manifest_dir", "m"],
          "train_seq2seq": [], "pretrain_paired": [],
          "transcribe": ["a.wav", "--checkpoint", "c.pt", "--dict_file",
                         "d.txt"],
          "serve": ["--checkpoint", "c.pt", "--dict_file", "d.txt"],
          "test": [], "embed": ["--root_dir", "r", "--checkpoint", "c.pt"],
          "train_transducer": [],
          "export": ["--checkpoint", "c.pt", "--dict_file", "d.txt",
                     "--output", "o"],
          "cluster_targets": ["--root_dir", "r", "--manifests", "t.tsv"],
          "pretrain_hubert": [], "pretrain_data2vec": ["--manifest_dir",
                                                       "m"],
          "convert_checkpoint": ["--input", "i", "--output", "o"]}
SSL_ENTRIES = ("cluster_targets", "pretrain_hubert", "pretrain_data2vec")


def captured_parser(module: str) -> argparse.ArgumentParser:
    """The parser ``module`` builds (in ``parse_args``, or in the JAX
    ``test.evaluate`` and ``convert_checkpoint.main``), caught before it
    parses."""
    caught = {}
    real = argparse.ArgumentParser.parse_args

    def catch(self, args=None, namespace=None):
        caught["parser"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = catch
    try:
        mod = importlib.import_module(module)
        for name in ("parse_args", "evaluate", "main"):
            if hasattr(mod, name):
                getattr(mod, name)([])
                break
    except SystemExit:
        pass
    finally:
        argparse.ArgumentParser.parse_args = real
    return caught["parser"]


def flags(parser):
    return {s: (a.default, a.choices, a.nargs) for a in parser._actions
            for s in a.option_strings if s.startswith("--")}


# choices the port's flag takes beyond the JAX one's, by (entry, flag)
PORT_CHOICES = {("convert_checkpoint", "--format"): ["orbax"]}


@pytest.mark.parametrize("entry", ENTRY_POINTS + (
    "convert_checkpoint", "learn_bpe", "wrd2bpe", "embed", "manifest",
    "train_ngram", "average_checkpoints", "inspect_checkpoint",
    "train_transducer", "train_lm") + SSL_ENTRIES)
def test_port_parses_every_jax_flag(entry):
    theirs = flags(captured_parser(f"audio8_tpu.cli.{entry}"))
    ours = flags(captured_parser(f"audio8_tpu_torch.cli.{entry}"))
    missing = set(theirs) - set(ours) - {"--lane_align"}
    assert not missing, f"{entry}: {sorted(missing)}"
    for flag in set(theirs) - {"--lane_align"}:
        want, got = theirs[flag], ours[flag]
        assert got[0] == want[0], f"{entry} {flag} default {got[0]}"
        extra = PORT_CHOICES.get((entry, flag), [])
        assert (sorted(got[1]) if got[1] else got[1]) == \
            (sorted(list(want[1]) + extra) if want[1] else want[1]), \
            f"{entry} {flag}"
        assert got[2] == want[2], f"{entry} {flag} nargs"


def parse_and_check(entry, extra):
    mod = importlib.import_module(f"audio8_tpu_torch.cli.{entry}")
    args = mod.parse_args(NEEDED[entry] + extra)
    check_ported(args, entry)
    return args


@pytest.mark.parametrize("entry,extra,item", [
    ("train", ["--pipeline_parallel", "2"], "item 8"),
    ("train", ["--tensor_parallel", "2", "--zero1", "true"], "item 8"),
    ("train", ["--moe_experts", "4", "--tensor_parallel", "2"],
     "item 8"),
    ("train", ["--distributed", "true", "--tensor_parallel", "2",
               "--fsdp", "true"], "item 8"),
    ("pretrain", ["--sequence_parallel", "true", "--tensor_parallel", "2",
                  "--zero1", "true"], "item 8"),
    ("test", ["--tensor_parallel", "2"], "item 8"),
    ("train_seq2seq", ["--distributed", "true", "--tensor_parallel", "2",
                       "--zero1", "true"], "item 8"),
    ("pretrain_paired", ["--distributed", "true", "--tensor_parallel", "2",
                         "--fsdp", "true"], "item 8"),
    ("pretrain_paired", ["--moe_experts", "4", "--tensor_parallel", "2"],
     "item 8"),
    ("export", ["--transducer", "true", "--tensor_parallel", "2"], "item 8"),
    ("train_transducer", ["--distributed", "true", "--tensor_parallel", "2",
                          "--zero1", "true"], "item 8"),
    ("train_transducer", ["--moe_experts", "4", "--tensor_parallel", "2"],
     "item 8"),
    ("pretrain_hubert", ["--distributed", "true", "--tensor_parallel", "2",
                         "--fsdp", "true"], "item 8"),
    ("pretrain_hubert", ["--tensor_parallel", "2", "--zero1", "true"],
     "item 8"),
    ("pretrain_hubert", ["--sequence_parallel", "true", "--tensor_parallel",
                         "2", "--moe_experts", "4"], "item 8"),
    ("pretrain_hubert", ["--moe_experts", "4", "--tensor_parallel", "2"],
     "item 8"),
    ("pretrain_data2vec", ["--distributed", "true", "--tensor_parallel", "2",
                           "--fsdp", "true"], "item 8"),
    ("pretrain_data2vec", ["--tensor_parallel", "2", "--zero1", "true"],
     "item 8"),
    ("pretrain_data2vec", ["--sequence_parallel", "true",
                           "--tensor_parallel", "2", "--moe_experts", "4"],
     "item 8"),
    ("pretrain_data2vec", ["--moe_experts", "4", "--tensor_parallel", "2"],
     "item 8"),
    ("cluster_targets", ["--tensor_parallel", "2"], "item 8"),
    ("cluster_targets", ["--moe_experts", "4", "--tensor_parallel", "2"],
     "item 8"),
])
def test_unported_values_raise_naming_their_item(entry, extra, item):
    """What is not ported raises, naming its ROADMAP.md item: pipelines;
    tensor parallelism where JAX refuses it (the decoders, the cluster
    tool) and, in the seven trainers that run it with
    ``--sequence_parallel``, beside MoE, ZeRO-1 or FSDP."""
    with pytest.raises(NotImplementedError, match=item):
        parse_and_check(entry, extra)


SHARDING_TRAINERS = ("train", "pretrain", "train_transducer",
                     "train_seq2seq", "pretrain_paired", "pretrain_hubert",
                     "pretrain_data2vec")
SHARDING_IGNORED = ("serve", "test", "transcribe", "embed", "export",
                    "cluster_targets", "convert_checkpoint")


@pytest.mark.parametrize("flag", ["--zero1", "--fsdp"])
@pytest.mark.parametrize("entry", SHARDING_TRAINERS + SHARDING_IGNORED)
def test_sharding_flags_pass(entry, flag):
    """``--zero1`` and ``--fsdp`` (item 8's first part, ported): the seven
    trainers that take them in JAX take them, with ``--distributed`` too;
    the entry points where JAX parses them and ignores them do the
    same."""
    args = parse_and_check(entry, [flag, "true"])
    assert getattr(args, flag[2:]) is True
    if entry in SHARDING_TRAINERS:
        args = parse_and_check(entry, [flag, "true", "--distributed",
                                       "true"])
        assert args.distributed is True


@pytest.mark.parametrize("entry,extra", [
    ("train", ["--zero1", "true", "--tensor_parallel", "2"]),
    ("pretrain", ["--fsdp", "true", "--sequence_parallel", "true",
                  "--tensor_parallel", "2"]),
    ("train", ["--fsdp", "true", "--pipeline_parallel", "2"]),
])
def test_model_parallel_flags_still_raise(entry, extra):
    """Tensor and sequence parallelism beside the sharding flags, and
    pipeline parallelism (item 8's rest), still raise."""
    with pytest.raises(NotImplementedError, match="item 8"):
        parse_and_check(entry, extra)


def _reaches(args, flag, tmp_path):
    """Whether ``flag`` of the parsed ``args`` reached what runs it."""
    import numpy as np

    from audio8_tpu_torch.cli.common import train_augmentation
    from audio8_tpu_torch.train.optim import SGD, create_lrs, create_optimizer
    from audio8_tpu_torch.train.profiler import StepProfiler

    if flag == "--remat":
        return AcousticConfig(**encoder_kwargs(args)).remat is True
    if flag in ("--noise_manifest", "--speed_perturb"):
        aug = train_augmentation(args)
        return (aug["noise_mixer"].files == [str(tmp_path / "n.wav")]
                if flag == "--noise_manifest"
                else list(aug["speed_perturb"]) == [0.9, 1.1])
    if flag == "--optim":
        return isinstance(create_optimizer(create_lrs(1e-3, 10),
                                           args.optim), SGD)
    if flag == "--profile_dir":
        return StepProfiler(args.profile_dir).trace_dir == str(tmp_path)
    from audio8_tpu_torch.cli.pretrain_paired import build_module
    from audio8_tpu_torch.models.warmstart import load_tlm_npz

    import torch

    text = build_module(args, 12, torch.float32).model.text_encoder
    report = load_tlm_npz(text, args.warmstart_text)
    return not report["unexpected"] and not report["missing_in_npz"] and \
        np.array_equal(text.embeddings.embedding.detach().numpy(),
                       np.load(args.warmstart_text)["embeddings/embedding"])


SMALL_PAIRED = ["--d_model", "32", "--num_heads", "2", "--num_layers", "1",
                "--d_ff", "64", "--text_d_model", "16", "--text_num_heads",
                "2", "--text_num_layers", "1", "--text_d_ff", "32"]


@pytest.mark.parametrize("entry,extra", [
    ("train", ["--remat", "true"]),
    ("train", ["--noise_manifest", "{tmp}"]),
    ("train", ["--speed_perturb", "0.9", "1.1"]),
    ("train", ["--optim", "sgd"]),
    ("train", ["--profile_dir", "{tmp}"]),
    ("pretrain", ["--remat", "true"]),
    ("pretrain", ["--profile_dir", "{tmp}"]),
    ("train_seq2seq", ["--noise_manifest", "{tmp}"]),
    ("train_seq2seq", ["--remat", "true"]),
    ("pretrain_paired", ["--warmstart_text", "{tmp}/tlm.npz"]),
    ("pretrain_paired", ["--remat", "true"]),
    ("pretrain_paired", ["--optim", "sgd"]),
    ("train_transducer", ["--remat", "true"]),
    ("train_transducer", ["--speed_perturb", "0.9", "1.1"]),
    ("train_transducer", ["--optim", "sgd"]),
    ("train_transducer", ["--profile_dir", "{tmp}"]),
])
def test_trainer_flags_reach_their_module(entry, extra, tmp_path):
    """Flags that raised naming items 4 and 10 before they were ported
    parse, pass the check and reach what runs them."""
    import numpy as np
    from scipy.io import wavfile

    extra = [a.replace("{tmp}", str(tmp_path)) for a in extra]
    if extra[0] == "--noise_manifest":
        wavfile.write(str(tmp_path / "n.wav"), 16000,
                      np.ones(100, np.int16))
    small = SMALL_PAIRED if entry == "pretrain_paired" else []
    if extra[0] == "--warmstart_text":  # a text tower of other weights
        import torch

        from audio8_tpu_torch.cli.pretrain_paired import (build_module,
                                                          parse_args)
        from audio8_tpu_torch.models.warmstart import save_tlm_npz

        other = build_module(parse_args(small), 12, torch.float32).model
        other.init_from(torch.Generator().manual_seed(1))
        save_tlm_npz(other.text_encoder, extra[1])
    args = parse_and_check(entry, small + extra)
    assert _reaches(args, extra[0], tmp_path)


@pytest.mark.parametrize("entry,extra", [
    ("train", ["--beam", "4"]),
    ("train", ["--lm", "x.arpa"]),
    ("train", ["--restart_from", "ckpt"]),
    ("train", ["--verbose", "true", "--restart_tt", "ignore"]),
    ("pretrain", ["--restart_from", "run"]),
    ("test", ["--beam", "8", "--lm", "x.arpa", "--verbose", "true"]),
    ("test", ["--quantize", "int8"]),
    ("transcribe", ["--beam", "8"]),
    ("transcribe", ["--lm", "x.arpa"]),
    ("transcribe", ["--timestamps", "true"]),
    ("transcribe", ["--vad", "true"]),
    ("transcribe", ["--quantize", "int8"]),
    ("serve", ["--lm", "x.arpa"]),
    ("serve", ["--beam", "8"]),
    ("serve", ["--timestamps", "true", "--quantize", "int8"]),
    ("embed", ["--reduction_type", "sha", "--batch", "4"]),
    ("train_seq2seq", ["--restart_from", "run", "--valid_beam", "4",
                       "--restart_tt", "ignore", "--freeze_fx", "false"]),
    ("pretrain_paired", ["--restart_from", "run", "--target_type", "bpe",
                         "--learn_temp", "false", "--stacking_layers", "8"]),
    ("train", ["--layer_drop", "0.1"]),
    ("train", ["--pre_norm", "true"]),
    ("train", ["--preset", "large-lv60"]),
    ("train", ["--causal_chunk_frames", "16"]),
    ("pretrain", ["--encoder_type", "conformer"]),
    ("pretrain", ["--preset", "wavlm-base"]),
    ("pretrain", ["--extractor_mode", "layer"]),
    ("pretrain", ["--pos_conv_depth", "5"]),
    ("embed", ["--preset", "wavlm-base"]),
    ("serve", ["--conv_bias", "true"]),
    ("train_seq2seq", ["--layer_drop", "0.1"]),
    ("train_seq2seq", ["--preset", "wavlm-base"]),
    ("pretrain_paired", ["--extractor_mode", "layer"]),
    ("transcribe", ["--transducer", "true", "--beam", "4",
                    "--max_symbols_per_frame", "2"]),
    ("serve", ["--transducer", "true", "--pred_dim", "64"]),
    ("test", ["--transducer", "true", "--beam", "4"]),
    ("export", ["--transducer", "true", "--window_frames", "128"]),
    ("train_transducer", ["--fused_loss", "true", "--valid_beam", "4",
                          "--restart_from", "run", "--freeze_fx", "false"]),
    ("transcribe", ["--device_beam", "true"]),
    ("serve", ["--device_beam", "true"]),
    ("test", ["--device_beam", "true"]),
    ("test", ["--beam", "4", "--lm_rescore", "lm_dir"]),
])
def test_ported_values_pass(entry, extra):
    """Values an entry point has ported pass its check (they raised
    before: the trainer's beam and LM flags, ``--restart_from``, the
    decoders' beam, LM, timestamps, VAD and int8; then LayerDrop in the
    trainers and every topology flag and preset but MoE)."""
    args = parse_and_check(entry, extra)
    assert all(getattr(args, a[2:]) is not None for a in extra
               if a.startswith("--"))


@pytest.mark.parametrize("entry,extra,exc,match", [
    ("transcribe", ["--transducer", "true", "--device_beam", "true"],
     SystemExit, "CTC-path"),
    ("serve", ["--transducer", "true", "--device_beam", "true"],
     SystemExit, "CTC-path"),
    ("test", ["--transducer", "true", "--device_beam", "true"],
     ValueError, "CTC-path"),
    ("test", ["--transducer", "true", "--lm_rescore", "lm_dir"],
     ValueError, "needs --beam > 1"),
    ("test", ["--lm_rescore", "lm_dir"], ValueError, "needs --beam > 1"),
])
def test_jax_refusals_of_the_decode_flags(entry, extra, exc, match,
                                          tmp_path):
    """The values that raised naming item 7 before it was ported pass the
    check, and the entry point refuses them where JAX does, before
    anything is loaded."""
    args = parse_and_check(entry, extra)
    assert all(getattr(args, a[2:]) is not None for a in extra
               if a.startswith("--"))
    with open(tmp_path / "dict.ltr.txt", "w") as f:
        f.write("A 1\n| 1\n")
    mod = importlib.import_module(f"audio8_tpu_torch.cli.{entry}")
    argv = NEEDED[entry] + extra
    with pytest.raises(exc, match=match):
        if entry == "serve":
            mod.build_service(mod.parse_args(argv))
        elif entry == "test":
            mod.evaluate(argv + ["--device", "cpu", "--root_dir",
                                 str(tmp_path)])
        else:
            mod.main(argv)


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_runnable_values_run(entry):
    extra = (["--alpha", "1.5"] if entry in ("train", "transcribe", "serve",
                                             "test") else []) + [
        "--moe_top_k", "2", "--conv_pos_kernel", "64",
        "--rel_pos_buckets", "16", "--pre_norm", "false",
        "--extractor_mode", "group", "--causal_left_chunks", "3",
        "--input_sample_rate", "16000"]
    if entry not in TRAINING_ENTRIES:  # inert at inference, as in JAX
        extra += ["--dropout", "0.3", "--attention_dropout", "0.2",
                  "--layer_drop", "0.5", "--pred_dim", "64",
                  "--max_symbols_per_frame", "2"]
    args = parse_and_check(entry, extra)
    cfg = AcousticConfig(**encoder_kwargs(args))
    check_supported(cfg)
    assert cfg.conv_pos_kernel == 64


@pytest.mark.parametrize("entry", SSL_ENTRIES)
def test_ssl_entries_default_to_the_card(entry):
    """The HuBERT and data2vec entry points parse with ``--device cuda``
    and take every topology preset but MoE."""
    args = parse_and_check(entry, [])
    assert args.device == "cuda"
    for preset in ("data2vec-base", "hubert-large", "wavlm-base"):
        parse_and_check(entry, ["--preset", preset])


def test_decoders_need_a_checkpoint_as_jax_does():
    mod = importlib.import_module("audio8_tpu_torch.cli.serve")
    with pytest.raises(SystemExit, match="--checkpoint and --dict_file"):
        mod.parse_args([])


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A tiny random CTC model and its pooled encoder exported for the
    CPU at one 1 s entry, a 0.8 s file and a two-file letter corpus."""
    import numpy as np
    import torch
    from scipy.io import wavfile

    from audio8_tpu_torch import export as E
    from audio8_tpu_torch.config import PooledConfig
    from audio8_tpu_torch.models.text import read_vocab_list
    from audio8_tpu_torch.models.wav2vec2 import (Wav2Vec2AcousticModel,
                                                  Wav2Vec2PooledEncoder)

    root = tmp_path_factory.mktemp("exported")
    fx = ((32, 10, 5), (32, 3, 2))
    (root / "dict.ltr.txt").write_text("".join(f"{c} 1\n"
                                               for c in "|ABC"))
    letters = read_vocab_list(str(root / "dict.ltr.txt"))
    size = dict(d_model=32, num_heads=2, num_layers=1, d_ff=64,
                custom_conv_features=fx)
    gen = torch.Generator().manual_seed(0)
    ctc = Wav2Vec2AcousticModel(AcousticConfig(
        num_labels=len(letters), timestep_masking=0.0,
        channel_masking=0.0, **size), generator=gen).eval()
    pooled = Wav2Vec2PooledEncoder(PooledConfig(
        reduction_type="mean", **size)).eval()
    heads = {"ctc": lambda out: (out[0], out[1].sum(-1)),
             "embed": lambda emb: emb.float()}
    for kind, model in (("ctc", ctc), ("embed", pooled)):
        state = model.state_dict()
        kwargs = {"freeze": False} if kind == "embed" else {}
        program = E.export_forward(E.state_fn(model, heads[kind], **kwargs),
                                   list(state), list(state.values()),
                                   16_000, torch.device("cpu"))
        E.save_artifact(str(root / kind), list(state.values()), {
            "kind": kind, "vocab": letters,
            "conv_features": [list(f) for f in fx], "sample_rate": 16_000,
            "d_model": 32, "num_layers": 1},
            [{"t": 16_000, "platform": "cpu", "program": program}])
    (root / "audio").mkdir()
    rng = np.random.default_rng(0)
    with open(root / "valid.tsv", "w") as tf, \
            open(root / "valid.ltr", "w") as lf:
        tf.write(str(root / "audio") + "\n")
        for i, n in enumerate((12_800, 9_000)):
            wavfile.write(str(root / "audio" / f"v{i}.wav"), 16_000,
                          (rng.normal(size=n) * 5000).astype(np.int16))
            tf.write(f"v{i}.wav\t{n}\n")
            lf.write("A B | C |\n")
    return root


@pytest.mark.parametrize("entry", ["transcribe", "serve", "test", "embed"])
def test_exported_artifact_decodes(entry, artifacts):
    """``--exported`` (which raised before item 6's export) loads an
    artifact and decodes in each of its four entry points."""
    from audio8_tpu_torch.utils import Offsets

    saved = (Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK,
             list(Offsets.VALUES))
    mod = importlib.import_module(f"audio8_tpu_torch.cli.{entry}")
    wav = str(artifacts / "audio" / "v0.wav")
    cpu = ["--device", "cpu"]
    try:
        if entry == "transcribe":
            rows = mod.main(["--exported", str(artifacts / "ctc"), *cpu,
                             wav])
            assert [r[0] for r in rows] == [wav]
            assert isinstance(rows[0][1], str)
        elif entry == "serve":
            service = mod.build_service(mod.parse_args(
                ["--exported", str(artifacts / "ctc"), *cpu,
                 "--context_seconds", "0.25", "--batch_wait_ms", "0"]))
            with open(wav, "rb") as f:
                got = service.transcribe(f.read())
            assert isinstance(got["text"], str)
            assert got["audio_seconds"] == 0.8
        elif entry == "test":
            got = mod.evaluate(["--exported", str(artifacts / "ctc"), *cpu,
                                "--root_dir", str(artifacts),
                                "--valid_dataset", "valid.tsv"])
            assert got["utterances"] == 2 and got["cer"] >= 0.0 <= got["wer"]
        else:
            out = str(artifacts / "emb")
            assert mod.main(["--exported", str(artifacts / "embed"), *cpu,
                             "--root_dir", str(artifacts), "--dataset",
                             "valid.tsv", "--output", out]) == 0
            import numpy as np

            assert np.load(out + ".npy").shape == (2, 32)
    finally:
        Offsets.PAD, Offsets.GO, Offsets.EOS, Offsets.UNK = saved[:4]
        Offsets.VALUES[:] = saved[4]
