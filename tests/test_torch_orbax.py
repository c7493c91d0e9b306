"""The port's Orbax reader and writer (``train/orbax.py`` over
``train/ocdbt.py``, ``train/zarr.py`` and the host library's zstd)
against the JAX package's ``load_checkpoint``, on the CPU. ``orbax``,
``tensorstore`` and ``zstandard`` are oracles here; the port imports none.

* Every dtype the reader takes (f4 f2 f8 i4 i8 u4 b1 i1 u1 and bfloat16,
  which arrives as ``torch.bfloat16`` bits), 0-d arrays, list and
  ``None`` leaves read bitwise as JAX restores them without a target, in
  both ``use_ocdbt`` layouts; a tree of 2 000 leaves reads bitwise from
  several data files, and its key list is tensorstore's ``ocdbt``
  listing. OCDBT databases written by tensorstore with small nodes (an
  interior B+tree level), out-of-line values and 300 commits (the version
  tree past its manifest) read as tensorstore reads them. A zarr array of
  several chunks (edge chunks, a missing one at ``fill_value``) and an
  empty array read as numpy has them. A corrupt data file raises, and
  without ``g++`` an OCDBT read raises.
* The writer's plain layout is restored by JAX's ``load_checkpoint``
  with and without a target (a ``TrainState`` of every ``--optim``),
  bitwise, and read back by the port.
* Every model kind (CTC, pretraining, HuBERT, data2vec and its teacher,
  seq2seq, paired, transducer, LM, a MoE CTC model): a JAX-written
  checkpoint of its init reads to ``params_from_jax`` of the in-memory
  tree, bitwise; ``jax_from_params`` of the port model is that tree, and
  ``params_from_jax(jax_from_params(m))`` is ``m.state_dict()``.
* The committed ``tests/fixtures/orbax_golden`` (the JAX package's own
  writes, ``tools/make_orbax_golden_fixtures.py``) reads bitwise to
  JAX's restore, and ``expected.npz`` re-derives from it.
* ``cli.inspect_checkpoint`` and ``cli.average_checkpoints`` on Orbax
  directories give what the JAX tools give.
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard

from audio8_tpu.train.checkpoint import load_checkpoint as jax_load
from audio8_tpu.train.checkpoint import save_checkpoint as jax_save
from audio8_tpu.train.optim import TrainState as JaxState
from audio8_tpu.train.optim import create_lrs as jax_lrs
from audio8_tpu.train.optim import create_optimizer as jax_opt
from audio8_tpu_torch.csrc import build as port_build
from audio8_tpu_torch.csrc import native
from audio8_tpu_torch.models.convert import (jax_from_params,
                                             params_from_jax)
from audio8_tpu_torch.train import orbax
from audio8_tpu_torch.train.ocdbt import OcdbtError, OcdbtStore
from audio8_tpu_torch.train.zarr import directory_getter, read_array
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "orbax_golden")


def assert_same(mine, theirs, path=""):
    """The port's tree equals JAX's restore: dicts, lists, ``None``, and
    arrays of one dtype and shape, bitwise (bfloat16 by its bits)."""
    if isinstance(theirs, dict):
        assert isinstance(mine, dict) and set(mine) == set(theirs), path
        for k in theirs:
            assert_same(mine[k], theirs[k], f"{path}/{k}")
    elif isinstance(theirs, (list, tuple)):
        assert isinstance(mine, list) and len(mine) == len(theirs), path
        for i, (a, b) in enumerate(zip(mine, theirs)):
            assert_same(a, b, f"{path}/{i}")
    elif theirs is None:
        assert mine is None, path
    else:
        theirs = np.asarray(theirs)
        if theirs.dtype == ml_dtypes.bfloat16:
            assert isinstance(mine, torch.Tensor), path
            assert mine.dtype == torch.bfloat16, path
            assert np.array_equal(mine.view(torch.int16).numpy(),
                                  theirs.view(np.int16)), path
        else:
            assert isinstance(mine, np.ndarray), path
            assert mine.dtype == theirs.dtype, (path, mine.dtype)
            assert mine.shape == theirs.shape, path
            assert np.array_equal(mine, theirs), path


def dtype_tree(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    return {
        "f4": f32, "f2": f32.astype(np.float16), "f8": f32.astype(np.float64),
        "i4": rng.integers(-9, 9, (4,)).astype(np.int32),
        "i8": rng.integers(-9, 9, (2, 2)).astype(np.int64),
        "u4": rng.integers(0, 9, (3,)).astype(np.uint32),
        "b1": rng.random(5) > 0.5,
        "i1": rng.integers(-9, 9, (6,)).astype(np.int8),
        "u1": rng.integers(0, 200, (6,)).astype(np.uint8),
        "bf16": f32.astype(ml_dtypes.bfloat16),
        "scalar": np.float32(2.5), "step": np.int32(7),
        "nested": {"list": [np.arange(3, dtype=np.int32), None,
                            {"x": np.ones((2, 1), np.float32)}]},
    }


def test_every_dtype_reads_as_jax_restores_it(tmp_path):
    path = jax_save(dtype_tree(), str(tmp_path / "checkpoint"), 7)
    with open(os.path.join(path, orbax.METADATA)) as f:
        assert json.load(f)["use_ocdbt"]
    assert orbax.is_orbax_dir(path)
    assert_same(orbax.load_checkpoint(path), jax_load(path))


def test_two_thousand_leaves_from_several_files(tmp_path):
    rng = np.random.default_rng(1)
    tree = {"params": {f"layer_{i}": {
        "kernel": rng.standard_normal((i % 7 + 1, 40)).astype(np.float32),
        "bias": rng.standard_normal(3).astype(np.float32)}
        for i in range(1000)},
        "big": rng.standard_normal((300, 300)).astype(np.float32)}
    path = jax_save(tree, str(tmp_path / "checkpoint"), 1)
    assert_same(orbax.load_checkpoint(path), jax_load(path))
    store = OcdbtStore(path)
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{path}/"}).result()
    assert store.keys() == sorted(kv.list().result())
    assert len(store.keys()) == 2 * 2001
    for k in store.keys():
        store.get(k)
    assert len(store._files) >= 2  # the root node and the value files


@pytest.mark.parametrize("commits", [1, 300])
def test_tensorstore_databases_with_small_nodes(tmp_path, commits):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 2000,
                                     "max_inline_value_bytes": 50}}
                         ).result()
    rng = np.random.default_rng(commits)
    values = {f"key/{i:05d}/x": rng.bytes(int(rng.integers(0, 120)))
              for i in range(300)}
    if commits == 1:
        txn = ts.Transaction()
        for k, v in values.items():
            kv.with_transaction(txn).write(k, v).result()
        txn.commit_async().result()
    else:
        for k, v in values.items():
            kv.write(k, v).result()
    store = OcdbtStore(str(tmp_path))
    assert store.keys() == sorted(k.encode() for k in values)
    for k, v in values.items():
        assert store.get(k.encode()) == v
    assert store.get(b"missing") is None


def test_zarr_chunk_grid_and_empty_arrays(tmp_path):
    rng = np.random.default_rng(2)
    full = rng.standard_normal((5, 7)).astype(np.float32)
    root = tmp_path / "grid"
    root.mkdir()
    meta = {"chunks": [2, 3], "compressor": {"id": "zstd", "level": 3},
            "dimension_separator": ".", "dtype": "<f4", "fill_value": -1.0,
            "filters": None, "order": "C", "shape": [5, 7],
            "zarr_format": 2}
    (root / ".zarray").write_text(json.dumps(meta))
    want = np.full((5, 7), -1.0, np.float32)
    for i in range(3):
        for j in range(3):
            if (i, j) == (1, 2):
                continue  # missing: fill_value
            chunk = np.zeros((2, 3), np.float32)  # edge chunks padded
            part = full[2 * i:2 * i + 2, 3 * j:3 * j + 3]
            chunk[:part.shape[0], :part.shape[1]] = part
            want[2 * i:2 * i + 2, 3 * j:3 * j + 3] = part
            (root / f"{i}.{j}").write_bytes(
                zstandard.ZstdCompressor().compress(chunk.tobytes()))
    got = read_array(directory_getter(str(tmp_path)), "grid")
    assert got.dtype == np.float32 and np.array_equal(got, want)
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / ".zarray").write_text(json.dumps(
        dict(meta, chunks=[1, 4], shape=[0, 4], compressor=None)))
    got = read_array(directory_getter(str(tmp_path)), "empty")
    assert got.shape == (0, 4) and got.dtype == np.float32
    with pytest.raises(ValueError, match="zero size"):
        orbax.save_checkpoint({"e": np.zeros((0, 4))}, str(tmp_path / "c"),
                              0)


def test_corrupt_files_raise(tmp_path):
    path = jax_save(dtype_tree(), str(tmp_path / "checkpoint"), 7)
    data = os.path.join(path, "d")
    name = os.path.join(data, sorted(os.listdir(data))[0])
    blob = bytearray(open(name, "rb").read())
    blob[len(blob) // 2] ^= 0x10
    open(name, "wb").write(bytes(blob))
    with pytest.raises(OcdbtError, match="CRC32C"):
        orbax.load_checkpoint(path)


def test_no_fallback_when_the_library_cannot_be_built(monkeypatch,
                                                      tmp_path):
    path = jax_save(dtype_tree(), str(tmp_path / "checkpoint"), 7)
    monkeypatch.setattr(port_build, "build_dir", lambda: str(tmp_path / "b"))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "_loaded", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        orbax.load_checkpoint(path)


@pytest.mark.parametrize("optim", ["adamw", "adam", "fused_adamw", "sgd"])
def test_writer_restores_in_jax_with_and_without_target(tmp_path, optim):
    rng = np.random.default_rng(3)
    params = {"a": {"kernel": rng.standard_normal((2, 3)).astype(
        np.float32)}, "b": rng.standard_normal(3).astype(np.float32)}
    tx = jax_opt(jax_lrs(1e-2, 10, warmup_steps=2), optim,
                 weight_decay=0.01)
    state = JaxState.create(jax.tree.map(jnp.asarray, params), tx)
    for i in range(3):
        grads = jax.tree.map(lambda p: jnp.full_like(p, 0.1 * (i + 1)),
                             state.params)
        state, _ = state.apply_gradients(grads, tx)
    saved = jax_save(state, str(tmp_path / "jax"), 3)
    mine = orbax.load_checkpoint(saved)
    path = orbax.save_checkpoint(mine, str(tmp_path / "port"), 3)
    assert os.path.basename(path) == "port-step-3"
    with open(os.path.join(path, orbax.METADATA)) as f:
        assert not json.load(f)["use_ocdbt"]
    assert_same(orbax.load_checkpoint(path), jax_load(saved))
    assert_same(mine, jax_load(path))
    restored = jax_load(path, JaxState.create(
        jax.tree.map(jnp.asarray, params), tx))
    assert type(restored.opt_state) is type(state.opt_state)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(state)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert int(restored.step) == 3


# ------------------------------------------------------------ every kind

def _ctc():
    from tests.test_torch_restart import _jax_init
    from audio8_tpu_torch.config import AcousticConfig
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
    from tests.test_torch_restart import CTC_CFG

    return _jax_init(True), Wav2Vec2AcousticModel(AcousticConfig(**CTC_CFG))


def _pretrain():
    from tests.test_torch_restart import PRE_CFG, _jax_init
    from audio8_tpu_torch.config import PretrainConfig
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2Model

    return _jax_init(False), Wav2Vec2Model(PretrainConfig(**PRE_CFG))


def _hubert():
    from tests.test_torch_hubert import CFG, jax_init
    from audio8_tpu_torch.models.hubert import (HubertPretrainConfig,
                                                HubertPretrainModel)

    return jax_init(CFG)[1], HubertPretrainModel(HubertPretrainConfig(**CFG))


def _data2vec():
    from tests.test_torch_data2vec import CFG, jax_init
    from audio8_tpu_torch.models.data2vec import (Data2VecAudioModel,
                                                  Data2VecPretrainConfig)

    return jax_init(CFG)[1], Data2VecAudioModel(Data2VecPretrainConfig(
        **CFG))


def _lm():
    from tests.test_torch_text_lm import CFG, jax_lm
    from audio8_tpu_torch.config import TextLMConfig
    from audio8_tpu_torch.models.text import CausalTextLM

    return jax_lm()[1], CausalTextLM(TextLMConfig(**CFG))


def _moe():
    from tests.test_torch_moe_model import EVAL, MOE, SIZE, jax_init
    from audio8_tpu_torch.config import AcousticConfig
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel

    cfg = dict(SIZE, **EVAL, **MOE)
    return jax_init(cfg), Wav2Vec2AcousticModel(AcousticConfig(**cfg))


def _paired():
    from tests.test_torch_paired import models

    _, _, params, module = models(0.0, jnp.float32, torch.float32)
    return params, module


def _seq2seq():
    from audio8_tpu.config import DecoderConfig as JaxDecoderConfig
    from audio8_tpu.config import EncoderConfig as JaxEncoderConfig
    from audio8_tpu.models.seq2seq import Seq2Seq as JaxSeq2Seq
    from tests.test_torch_seq2seq_steps import DEC, ENC, _batch
    from audio8_tpu_torch.config import DecoderConfig, EncoderConfig
    from audio8_tpu_torch.models.seq2seq import Seq2Seq

    b = {k: jnp.asarray(v) for k, v in _batch(1).items()}
    jmodel = JaxSeq2Seq(encoder_config=JaxEncoderConfig(**ENC),
                        decoder_config=JaxDecoderConfig(**DEC))
    params = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), b["signal"], b["signal_lengths"],
        b["token_ids"][:, :-1], b["token_lengths"])["params"]
    return params, Seq2Seq(EncoderConfig(**ENC), DecoderConfig(**DEC))


def _transducer():
    from audio8_tpu.config import TransducerConfig as JaxConfig
    from audio8_tpu.models.transducer import Transducer as JaxTransducer
    from tests.test_torch_transducer_model import CFG, LENGTHS, _inputs
    from audio8_tpu_torch.config import TransducerConfig
    from audio8_tpu_torch.models.transducer import Transducer

    x, y = _inputs()
    params = jax.jit(JaxTransducer(config=JaxConfig(**CFG)).init)(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(LENGTHS),
        jnp.asarray(y))["params"]
    return params, Transducer(TransducerConfig(**CFG))


KINDS = {"ctc": _ctc, "pretrain": _pretrain, "hubert": _hubert,
         "data2vec": _data2vec, "seq2seq": _seq2seq, "paired": _paired,
         "transducer": _transducer, "lm": _lm, "moe": _moe}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_every_kind_reads_to_params_from_jax(kind, tmp_path):
    params, model = KINDS[kind]()
    params = jax.tree.map(np.asarray, dict(params))
    want = params_from_jax(params)
    model.load_state_dict(want, strict=True)
    mine = jax_from_params(model)
    assert jax.tree.structure(mine) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    back = params_from_jax(mine)
    own = model.state_dict()
    assert set(back) == set(own)
    for k, v in own.items():
        assert torch.equal(back[k], v), k
    saved = jax_save({"params": params}, str(tmp_path / "checkpoint"), 4)
    read = orbax.load_checkpoint(saved)
    got = params_from_jax(read["params"])
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    if kind == "data2vec":  # the EMA teacher: a bare params tree
        from audio8_tpu_torch.train.checkpoint import load_teacher

        teacher = jax.tree.map(lambda x: x * np.float32(0.5), params)
        jax_save(teacher, str(tmp_path / "teacher"), 4)
        _, student = KINDS[kind]()
        assert load_teacher(student, str(tmp_path)) == str(
            tmp_path / "teacher-step-4")
        half = params_from_jax(teacher)
        for k, v in student.state_dict().items():
            assert torch.equal(v, half[k]), k


# ------------------------------------------------------------ the fixture

@pytest.mark.parametrize("kind", ["ctc", "pretrain"])
def test_golden_fixture_reads_bitwise(kind):
    path = os.path.join(GOLDEN, kind, "checkpoint-step-2")
    with open(os.path.join(GOLDEN, "MANIFEST.json")) as f:
        manifest = json.load(f)
    assert manifest["total_bytes"] < 2 << 20
    mine = orbax.load_checkpoint(path)
    assert_same(mine, jax_load(path))
    # expected.npz re-derived from the committed directory (JAX's read)
    theirs = jax.tree.map(np.asarray, jax_load(path))
    sd, (count, mu, nu) = params_from_jax(theirs["params"],
                                          theirs["opt_state"])
    expected = np.load(os.path.join(GOLDEN, "expected.npz"))
    prefix = f"{kind}/"
    names = {k[len(prefix):] for k in expected.files
             if k.startswith(prefix)}
    derived = {"count": np.asarray(count),
               "step": np.asarray(int(theirs["step"]))}
    for part, d in (("params", sd), ("mu", mu), ("nu", nu)):
        derived.update({f"{part}/{k}": v.numpy() for k, v in d.items()})
    assert names == set(derived)
    for k, v in derived.items():
        assert np.array_equal(expected[prefix + k], v), k
    # and the port's own read gives the same state
    sd2, (count2, mu2, nu2) = params_from_jax(mine["params"],
                                              mine["opt_state"])
    assert count2 == count == 2
    for a, b in ((sd, sd2), (mu, mu2), (nu, nu2)):
        for k in a:
            assert torch.equal(a[k], b[k]), k


# ------------------------------------------------------------- the tools

def test_inspect_matches_the_jax_tool(tmp_path):
    from audio8_tpu.cli import inspect_checkpoint as jax_inspect
    from audio8_tpu_torch.cli import inspect_checkpoint

    path = os.path.join(GOLDEN, "ctc", "checkpoint-step-2")
    for target in (path, os.path.dirname(path)):
        mine = inspect_checkpoint.main([target, "--json", "--tree"])
        theirs = jax_inspect.main([target, "--json", "--tree"])
        assert mine == theirs
    bf = jax_save({"params": {"w": np.ones((2, 3), ml_dtypes.bfloat16),
                              "b": np.zeros(3, np.float32)}},
                  str(tmp_path / "checkpoint"), 5)
    assert inspect_checkpoint.main([bf, "--json"]) == jax_inspect.main(
        [bf, "--json"])


def test_average_matches_the_jax_tool(tmp_path):
    from audio8_tpu.cli import average_checkpoints as jax_average
    from audio8_tpu_torch.cli import average_checkpoints

    src = str(tmp_path / "run")
    shutil.copytree(os.path.join(GOLDEN, "ctc"), src)
    tree = jax.tree.map(np.asarray, jax_load(os.path.join(
        src, "checkpoint-step-2")))
    tree["params"] = jax.tree.map(lambda x: x * np.float32(3.0),
                                  tree["params"])
    tree["step"] = np.int32(5)
    jax_save(tree, os.path.join(src, "checkpoint"), 5)
    mine = average_checkpoints.main(["--basedir", src, "--output",
                                     str(tmp_path / "mine")])
    theirs = jax_average.main(["--basedir", src, "--output",
                               str(tmp_path / "theirs")])
    assert os.path.basename(mine) == "mine-avg-5"
    assert os.path.basename(theirs) == "theirs-avg-5"
    assert_same(orbax.load_checkpoint(mine), jax_load(theirs))
