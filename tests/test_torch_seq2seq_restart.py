"""JAX's ``train_seq2seq`` and the port's, both warm-started with
``--restart_from`` from one pretraining ``.pt`` that the port saved (its
encoder fills the seq2seq encoder on both sides), log the same losses:
step 1 within rtol 1e-4, the next within 1e-3 (dropout and masking off,
the same batches from the same manifest). The decoder, which the ``.pt``
does not hold, starts from the JAX trainer's own init on both sides:
the test records the tree JAX's ``resolve_restart`` is given and loads
it into the port's model before the warm start.
"""
import numpy as np
import torch

from audio8_tpu.cli import train_seq2seq as jax_cli
from audio8_tpu_torch.cli import train_seq2seq as s2s_cli
from audio8_tpu_torch.config import PretrainConfig
from audio8_tpu_torch.models.convert import (params_from_jax,
                                             save_fairseq_pretrained)
from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2Model

from tests.test_torch_seq2seq_cli import _args
from tests.test_torch_train_cli import _restore_port_offsets, corpus  # noqa: F401
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()


def test_both_trainers_restart_from_one_pt(corpus, tmp_path, monkeypatch):
    pt = str(tmp_path / "pretrained.pt")
    save_fairseq_pretrained(Wav2Vec2Model(
        PretrainConfig(d_model=32, num_heads=2, num_layers=1, d_ff=64,
                       final_dim=16, num_vq_vars=8),
        generator=torch.Generator().manual_seed(11)), pt)

    captured, recorded = {}, []
    real_restart, real_steps = jax_cli.resolve_restart, \
        jax_cli.make_seq2seq_steps

    def restart(path, init_params, *a, **kw):
        captured["init"] = _tree(init_params)  # before donation frees it
        return real_restart(path, init_params, *a, **kw)

    def steps(*a, **kw):
        grad_fn, update_fn, decode_fn, eval_fn = real_steps(*a, **kw)

        def recording(*args, **kwargs):
            out = grad_fn(*args, **kwargs)
            recorded.append(float(out[0]))
            return out

        return recording, update_fn, decode_fn, eval_fn

    monkeypatch.setattr(jax_cli, "resolve_restart", restart)
    monkeypatch.setattr(jax_cli, "make_seq2seq_steps", steps)
    args = _args(corpus, str(tmp_path / "jax"), "2")
    for flag, value in (("--timestep_masking", "0.0"),
                        ("--freeze_fx", "true"),
                        ("--steps_per_checkpoint", "100")):
        args[args.index(flag) + 1] = value
    args = [a for a in args if a not in ("--device", "cpu")] + [
        "--restart_from", pt, "--dropout", "0.0", "--decoder_dropout",
        "0.0", "--channel_masking", "0.0", "--grad_accum", "1",
        "--valid_steps", "0"]
    jax_cli.train(args + ["--lane_align", "false"])

    init = params_from_jax(captured["init"])
    real_build = s2s_cli.build_model

    def build(*a, **kw):
        model = real_build(*a, **kw)
        model.load_state_dict(init, strict=True)
        return model

    monkeypatch.setattr(s2s_cli, "build_model", build)
    args[args.index("--basedir") + 1] = str(tmp_path / "port")
    state = s2s_cli.train(args + ["--device", "cpu"])
    losses = [r["loss"] for r in state.log]
    assert len(recorded) == len(losses) == 2
    np.testing.assert_allclose(losses[0], recorded[0], rtol=1e-4)
    np.testing.assert_allclose(losses, recorded, rtol=1e-3)


def _tree(node):
    """A flax tree as nested dicts of numpy copies."""
    if hasattr(node, "items"):
        return {k: _tree(v) for k, v in node.items()}
    return np.array(node)

