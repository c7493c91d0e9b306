"""Write ``tests/fixtures/orbax_golden/``: Orbax checkpoints written by the
JAX package's own ``save_checkpoint``, which the port must read without
``orbax``, ``tensorstore`` or ``zstandard``.

* ``ctc/checkpoint-step-2``: a tiny CTC ``TrainState`` after 2 ``adamw``
  steps (``make_ctc_steps``, dropout and masking off) on a seeded batch;
* ``pretrain/checkpoint-step-2``: a tiny pretraining ``TrainState`` after
  2 ``fused_adamw`` steps (``make_pretrain_steps``);
* ``expected.npz``: each state in the port's layout, through the port's
  ``models/convert.py:params_from_jax`` of the in-memory JAX state
  (``<kind>/params/<name>``, ``<kind>/mu/<name>``, ``<kind>/nu/<name>``,
  ``<kind>/count``, ``<kind>/step``);
* ``MANIFEST.json``: the configs, the optimizer and schedule, the batch
  seeds, the Offsets remap, the files and their sizes, and the versions
  that wrote them.

Run from the repository root, on the CPU (the Pallas AdamW runs in
interpret mode):

    JAX_PLATFORMS=cpu python tools/make_orbax_golden_fixtures.py
"""
from __future__ import annotations

import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

OUT = os.path.join(ROOT, "tests", "fixtures", "orbax_golden")
FX = [[32, 10, 5], [32, 3, 2]]
SIZE = dict(d_model=32, num_heads=2, num_layers=1, d_ff=64,
            custom_conv_features=FX, dropout=0.0, attention_dropout=0.0,
            dropout_input=0.0, dropout_features=0.0)
CTC = dict(SIZE, num_labels=12, timestep_masking=0.0, channel_masking=0.0,
           freeze_fx=False)
PRETRAIN = dict(SIZE, num_vq_vars=8, num_vq_groups=2, final_dim=16,
                n_negatives=10)
SCHEDULE = dict(lr=1e-3, train_steps=10, sched_type="cosine",
                warmup_steps=2)
OPTIM = {"ctc": dict(optim="adamw", weight_decay=0.01, clip=25.0),
         "pretrain": dict(optim="fused_adamw", weight_decay=0.01,
                          clip=1.0)}
STEPS = 2


def ctc_batch(seed: int) -> dict:
    """Three rows of 2400 samples (one all padding), fairseq-remapped
    token ids (PAD 1) from 4."""
    rng = np.random.default_rng(seed)
    b, t, u = 3, 2400, 6
    lengths = np.array([t, 1700, 0], np.int32)
    signal = rng.normal(size=(b, t)).astype(np.float32)
    signal[np.arange(t)[None, :] >= lengths[:, None]] = 0.0
    tokens = rng.integers(4, CTC["num_labels"], size=(b, u)).astype(np.int32)
    tok_len = np.array([u, u - 2, 0], np.int32)
    tokens[np.arange(u)[None, :] >= tok_len[:, None]] = 1
    return {"signal": signal, "signal_lengths": lengths,
            "token_ids": tokens, "token_lengths": tok_len}


def pretrain_signal(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(2, 4000)).astype(
        np.float32)


def _tree(x):
    import jax

    return jax.tree.map(np.asarray, x)


def _expected(kind: str, state, out: dict) -> None:
    from audio8_tpu_torch.models.convert import params_from_jax

    sd, (count, mu, nu) = params_from_jax(_tree(state.params),
                                          _tree(state.opt_state))
    for name, d in (("params", sd), ("mu", mu), ("nu", nu)):
        for k, v in d.items():
            out[f"{kind}/{name}/{k}"] = v.numpy()
    out[f"{kind}/count"] = np.asarray(count)
    out[f"{kind}/step"] = np.asarray(int(state.step))


def ctc_state():
    import jax
    import jax.numpy as jnp

    from audio8_tpu.config import AcousticConfig
    from audio8_tpu.models.wav2vec2 import Wav2Vec2AcousticModel
    from audio8_tpu.train import steps
    from audio8_tpu.train.optim import TrainState, create_lrs, \
        create_optimizer
    from audio8_tpu.utils import Offsets

    Offsets.remap_fairseq_ctc()
    batch = {k: jnp.asarray(v) for k, v in ctc_batch(1).items()}
    model = Wav2Vec2AcousticModel(config=AcousticConfig(**CTC))
    params = model.init(jax.random.PRNGKey(0), batch["signal"],
                        batch["signal_lengths"])["params"]
    opt = OPTIM["ctc"]
    tx = create_optimizer(create_lrs(**SCHEDULE), opt["optim"],
                          opt["weight_decay"])
    state = TrainState.create(params, tx)
    grad, update, _ = steps.make_ctc_steps(model, tx, clip=opt["clip"])
    losses = []
    for i in range(STEPS):
        loss, g, bsz, _ = grad(state.params, batch,
                               jax.random.PRNGKey(i), freeze=False)
        state, _ = update(state, g, bsz)
        losses.append(float(loss))
    return state, losses


def pretrain_state():
    import jax

    from audio8_tpu.config import PretrainConfig
    from audio8_tpu.models.wav2vec2 import Wav2Vec2Model
    from audio8_tpu.train import steps
    from audio8_tpu.train.optim import TrainState, create_lrs, \
        create_optimizer

    signal = pretrain_signal(2)
    cfg = PretrainConfig(**PRETRAIN)
    rngs = {k: jax.random.PRNGKey(i)
            for i, k in enumerate(("params", "mask", "gumbel", "dropout"))}
    params = Wav2Vec2Model(config=cfg).init(rngs, signal,
                                            train=True)["params"]
    opt = OPTIM["pretrain"]
    tx = create_optimizer(create_lrs(**SCHEDULE), opt["optim"],
                          opt["weight_decay"])
    state = TrainState.create(params, tx)
    step, _ = steps.make_pretrain_steps(
        Wav2Vec2Model(config=cfg), tx, clip=opt["clip"],
        n_negatives=PRETRAIN["n_negatives"])
    losses = []
    for key in jax.random.split(jax.random.PRNGKey(23), STEPS):
        state, metrics = step(state, signal, key)
        losses.append(float(metrics["loss"]))
    return state, losses


def main() -> None:
    from importlib.metadata import version

    import jax

    from audio8_tpu.train.checkpoint import save_checkpoint

    jax.config.update("jax_platforms", "cpu")
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    expected, losses = {}, {}
    for kind, make in (("ctc", ctc_state), ("pretrain", pretrain_state)):
        state, losses[kind] = make()
        save_checkpoint(state, os.path.join(OUT, kind, "checkpoint"),
                        int(state.step))
        _expected(kind, state, expected)
    np.savez(os.path.join(OUT, "expected.npz"), **expected)
    files = {}
    for d, _, names in sorted(os.walk(OUT)):
        for n in sorted(names):
            path = os.path.join(d, n)
            files[os.path.relpath(path, OUT)] = os.path.getsize(path)
    manifest = {
        "ctc": {"config": CTC, "batch_seed": 1, **OPTIM["ctc"],
                "losses": losses["ctc"]},
        "pretrain": {"config": PRETRAIN, "signal_seed": 2,
                     "step_keys": "jax.random.split(PRNGKey(23), 2)",
                     **OPTIM["pretrain"], "losses": losses["pretrain"]},
        "schedule": SCHEDULE, "steps": STEPS,
        "offsets": "fairseq_ctc (Offsets.remap_fairseq_ctc)",
        "files": files, "total_bytes": sum(files.values()),
        "versions": {p: version(p) for p in ("jax", "orbax-checkpoint",
                                             "tensorstore")},
    }
    with open(os.path.join(OUT, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    print(f"wrote {OUT}: {manifest['total_bytes']} bytes")


if __name__ == "__main__":
    main()
