"""The tensor-parallel split table (``parallel/tensor.py:split_table``)
against JAX's ``param_shardings(params, make_mesh(data=4, model=2),
TP_RULES)`` leaf by leaf, for the CTC, pretraining, seq2seq, paired and
conformer trees (and, at a model extent of 4, JAX's fallback to
replication where the extent does not divide an axis); and the
refusals: an extent that does not divide the ranks, heads or FFN
columns that a rank cannot own whole, and expert parallelism, ZeRO-1,
FSDP and pipelines beside tensor parallelism, each naming ROADMAP.md's
item 8."""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio8_tpu.config import AcousticConfig as JaxConfig
from audio8_tpu.models.wav2vec2 import Wav2Vec2AcousticModel as JaxModel
from audio8_tpu.parallel.sharding import (TP_RULES, _path_str, make_mesh,
                                          param_shardings)
from audio8_tpu_torch.cli.common import (add_common_model_args,
                                         apply_preset, check_ported)
from audio8_tpu_torch.config import AcousticConfig
from audio8_tpu_torch.models.convert import _conv, _t, model_assignments
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
from audio8_tpu_torch.parallel import sharding
from audio8_tpu_torch.parallel.tensor import (ModelGroup, shard_model,
                                              split_table)
from tests.test_torch_orbax import _ctc, _paired, _pretrain, _seq2seq
from tests.test_torch_restart import CTC_CFG
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

CONFORMER = dict(CTC_CFG, encoder_type="conformer", extractor_mode="layer",
                 conv_bias=True, position_embeddings_type="relative",
                 conv_depthwise_kernel_size=7)


def _conformer(cfg=CONFORMER):
    params = JaxModel(config=JaxConfig(**cfg)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4000)))["params"]
    return params, Wav2Vec2AcousticModel(AcousticConfig(**cfg))


def _odd_ffn():
    cfg = dict(CTC_CFG, d_ff=70)
    params = JaxModel(config=JaxConfig(**cfg)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4000)))["params"]
    return params, Wav2Vec2AcousticModel(AcousticConfig(**cfg))


def jax_table(params, model, mesh) -> dict:
    """JAX's placement of each leaf as the port's split dimension: the
    leaf's ``'model'`` axis through the port's transform, or None."""
    shardings = param_shardings(params, mesh, TP_RULES)
    specs = {_path_str(p): s.spec for p, s in
             jax.tree_util.tree_flatten_with_path(shardings)[0]}
    state = model.state_dict()
    out = {}
    for path, key, tf in model_assignments(model):
        axes = [j for j, a in enumerate(specs["/".join(path)]) if a == "model"]
        if not axes:
            out[key] = None
            continue
        nd = state[key].dim()
        out[key] = nd - 1 - axes[0] if tf is _t or tf is _conv else axes[0]
    return out


TREES = {"ctc": _ctc, "pretrain": _pretrain, "seq2seq": _seq2seq,
         "paired": _paired, "conformer": _conformer}


@pytest.mark.parametrize("kind", sorted(TREES))
def test_split_table_is_jax_tp_rules(kind):
    params, model = TREES[kind]()
    params = jax.tree.map(np.asarray, dict(params))
    want = jax_table(params, model, make_mesh(data=4, model=2))
    got = split_table(model, 2)
    assert got == want
    split = [k for k, d in got.items() if d is not None]
    assert split, kind
    if kind == "conformer":  # its attention, not its FFNs ("ffn1/expand")
        assert all(".self_attn.linear_" in k for k in split)
        assert not any(".linear_pos." in k for k in split)
    if kind == "seq2seq":
        assert any(".src_attn." in k for k in split)


def test_jax_fallback_to_replication():
    params, model = _odd_ffn()
    params = jax.tree.map(np.asarray, dict(params))
    want = jax_table(params, model, make_mesh(data=2, model=4))
    got = split_table(model, 4)
    assert got == want
    assert got["encoder.encoder.layers.0.fc1.weight"] is None
    assert got["encoder.encoder.layers.0.self_attn.q_proj.weight"] == 0
    assert got["encoder.encoder.layers.0.self_attn.out_proj.weight"] == 1
    # the port's ranks own whole FFN column blocks: a d_ff the extent
    # does not divide is refused, naming the field
    with pytest.raises(ValueError, match="d_ff 70"):
        shard_model(model, ModelGroup(None, 0, 4))


def test_heads_a_rank_cannot_own_whole_raise():
    model = Wav2Vec2AcousticModel(AcousticConfig(**dict(
        CTC_CFG, d_model=48, num_heads=3, d_ff=96)))
    with pytest.raises(ValueError, match="num_heads 3"):
        shard_model(model, ModelGroup(None, 0, 2))


def test_extent_that_does_not_divide_the_ranks_raises(monkeypatch):
    with pytest.raises(ValueError, match="--tensor_parallel"):
        sharding.setup(True, "cpu", tensor_parallel=2)  # one process
    monkeypatch.setattr(sharding.dist, "get_world_size", lambda: 3)
    with pytest.raises(ValueError, match=r"\(--tensor_parallel\) does not "
                                         r"divide the 3 ranks"):
        sharding.make_groups(2)


def _args(argv):
    parser = argparse.ArgumentParser()
    add_common_model_args(parser)
    parser.add_argument("--pipeline_parallel", type=int, default=1)
    return apply_preset(parser.parse_args(argv))


@pytest.mark.parametrize("flags", [
    ["--moe_experts", "4"], ["--zero1", "true"], ["--fsdp", "true"]])
def test_refused_beside_tensor_parallel(flags):
    for entry in ("train", "pretrain", "train_seq2seq", "pretrain_data2vec"):
        with pytest.raises(NotImplementedError, match="item 8"):
            check_ported(_args(flags + ["--tensor_parallel", "2"]), entry)
        check_ported(_args(flags), entry)  # without it, ported
    check_ported(_args(["--tensor_parallel", "2", "--sequence_parallel",
                        "true"]), "train")


def test_pipeline_and_decoders_still_refuse():
    with pytest.raises(NotImplementedError, match="item 8"):
        check_ported(_args(["--pipeline_parallel", "2"]), "train")
    for entry in ("test", "transcribe", "serve", "embed", "export"):
        with pytest.raises(NotImplementedError, match="item 8"):
            check_ported(_args(["--tensor_parallel", "2"]), entry)


def test_moe_layer_refused_by_the_sharding():
    model = Wav2Vec2AcousticModel(AcousticConfig(**dict(
        CTC_CFG, moe_experts=2)))
    with pytest.raises(NotImplementedError, match="item 8"):
        shard_model(model, ModelGroup(None, 0, 2))
    assert all(p.shape == q.shape for p, q in zip(
        model.parameters(), Wav2Vec2AcousticModel(AcousticConfig(**dict(
            CTC_CFG, moe_experts=2))).parameters()))
    assert torch.is_tensor(next(model.parameters()))
