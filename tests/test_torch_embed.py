"""``cli.embed`` of the port against the JAX package's on one random
pooled encoder (the JAX package's checkpoint, and the same weights as
the port's paired ``.pt``), ``mean`` pooling over batches padded to
whole seconds: the vectors within 1e-4 of JAX's, unit norms
within 1e-4, the ``.tsv`` rows equal and the ``--trials`` EER equal. The
port's paired ``.pt`` gives its audio tower, and a fairseq pretrained
``.pt`` and an HF ``save_pretrained`` directory their encoders;
``--exported`` of a transducer artifact raises naming its ROADMAP
item."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

import audio8_tpu.cli.embed as jax_embed
import audio8_tpu.config as jax_config
from audio8_tpu.models.wav2vec2 import Wav2Vec2PooledEncoder as JaxPooled
from audio8_tpu.train.checkpoint import save_checkpoint
from audio8_tpu_torch.cli import embed
from audio8_tpu_torch.config import PooledConfig, PretrainConfig
from audio8_tpu_torch.models.convert import (params_from_jax,
                                             save_fairseq_pretrained)
from audio8_tpu_torch.models.wav2vec2 import (Wav2Vec2PooledEncoder,
                                              create_model, init_weights)
from tests.test_torch_threads import cap_torch_threads

cap_torch_threads()

SIZE = ["--d_model", "32", "--num_heads", "2", "--num_layers", "1",
        "--d_ff", "64"]
TOL = 1e-4


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """One random pooled encoder (``mean``: no head weights) as the JAX
    package's checkpoint and as the port's paired ``.pt``."""
    root = tmp_path_factory.mktemp("embed_ckpt")
    cfg = jax_config.PooledConfig(
        d_model=32, num_heads=2, num_layers=1, d_ff=64, dropout=0.0,
        timestep_masking=0.0, channel_masking=0.0, freeze_fx=False,
        reduction_type="mean")
    params = JaxPooled(config=cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16_000), jnp.float32),
        jnp.asarray([16_000]))["params"]
    jax_ckpt = save_checkpoint(params, str(root / "ckpt"), 1)
    # the encoder body's mapping is the acoustic model's, under "encoder."
    body = jax.tree.map(np.asarray, {"encoder": params["encoder"], "proj": {
        "kernel": np.zeros((32, 4), np.float32),
        "bias": np.zeros(4, np.float32)}})
    state = {embed.AUDIO_PREFIX + k: v
             for k, v in params_from_jax(body).items()
             if k.startswith("encoder.")}
    port_ckpt = str(root / "paired.pt")
    torch.save({"kind": "paired", "model": state}, port_ckpt)
    return jax_ckpt, port_ckpt


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("embed")
    audio = root / "audio"
    audio.mkdir()
    rng = np.random.default_rng(3)
    with open(root / "test.tsv", "w") as tf:
        tf.write(str(audio) + "\n")
        for i in range(6):  # 0.5-2.6 s: batches pad to 2 and 3 s
            n = 8_000 + 6_500 * i
            wavfile.write(str(audio / f"u{i}.wav"), 16_000,
                          (rng.normal(size=n) * 5000).astype(np.int16))
            tf.write(f"u{i}.wav\t{n}\n")
    (root / "trials.txt").write_text(
        "u0.wav u0.wav 1\nu1.wav u2.wav 1\nu3.wav u3.wav 1\n"
        "u0.wav u5.wav 0\nu1.wav u4.wav 0\nu2.wav u3.wav 0\n")
    return root


def test_vectors_and_eer_match_jax(checkpoints, corpus, tmp_path, capsys):
    jax_ckpt, port_ckpt = checkpoints
    common = ["--root_dir", str(corpus), "--dataset", "test.tsv",
              "--reduction_type", "mean", "--batch", "4", *SIZE]
    jax_args = common + ["--checkpoint", jax_ckpt]
    port_args = common + ["--checkpoint", port_ckpt, "--device", "cpu"]
    theirs, mine = str(tmp_path / "jax"), str(tmp_path / "port")
    assert jax_embed.main(jax_args + ["--output", theirs]) == 0
    assert embed.main(port_args + ["--output", mine]) == 0
    want, got = np.load(theirs + ".npy"), np.load(mine + ".npy")
    assert got.shape == want.shape == (6, 32) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=TOL)
    with open(theirs + ".tsv") as a, open(mine + ".tsv") as b:
        assert a.read() == b.read()
    capsys.readouterr()
    trials = ["--trials", str(corpus / "trials.txt")]
    jax_embed.main(jax_args + trials)
    eer_jax = capsys.readouterr().out.strip().splitlines()[-1]
    embed.main(port_args + trials)
    eer_port = capsys.readouterr().out.strip().splitlines()[-1]
    assert eer_port == eer_jax and eer_port.startswith("eer ")


def test_paired_checkpoint_gives_its_audio_tower(tmp_path):
    cfg = PooledConfig(d_model=32, num_heads=2, num_layers=1, d_ff=64,
                       dropout=0.0, timestep_masking=0.0,
                       channel_masking=0.0, reduction_type="sha")
    tower = Wav2Vec2PooledEncoder(cfg)
    init_weights(tower, torch.Generator().manual_seed(0),
                 tower.encoder.mask_emb)
    path = str(tmp_path / "paired.pt")
    torch.save({"kind": "paired", "model": {
        **{embed.AUDIO_PREFIX + k: v for k, v in tower.state_dict().items()},
        "model.text_encoder.w": torch.zeros(2)}}, path)
    fresh = Wav2Vec2PooledEncoder(cfg)
    embed.load_pooled_weights(path, fresh)
    for k, v in tower.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_fairseq_pretrained_gives_its_encoder(tmp_path):
    """The pretraining trainer's checkpoint (fairseq layout): its encoder
    body fills the pooled encoder's ``encoder``."""
    kw = dict(d_model=32, num_heads=2, num_layers=1, d_ff=64)
    pre = create_model(PretrainConfig(final_dim=16, num_vq_vars=8, **kw),
                       generator=torch.Generator().manual_seed(1))
    path = str(tmp_path / "checkpoint-step-5.pt")
    save_fairseq_pretrained(pre, path)
    pooled = Wav2Vec2PooledEncoder(PooledConfig(reduction_type="mean", **kw))
    embed.load_pooled_weights(path, pooled)
    theirs = pre.state_dict()
    for k, v in pooled.encoder.state_dict().items():
        assert torch.equal(v, theirs[k]), k


def test_unported_sources_raise(tmp_path, corpus):
    """``--exported`` runs ``cli.export`` artifacts (item 6's export) but
    not a transducer's, which waits for RNN-T (item 7)."""
    import json

    art = tmp_path / "rnnt"
    art.mkdir()
    (art / "meta.json").write_text(json.dumps({"kind": "transducer"}))
    base = ["--root_dir", str(corpus), "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="item 7"):
        embed.build_embedder(embed.parse_args(base + ["--exported",
                                                      str(art)]))


def test_hf_directory_gives_its_encoder(tmp_path):
    """A ForCTC HF directory (HuBERT's) fills the pooled encoder's
    ``encoder`` with its own encoder, the head dropped."""
    from audio8_tpu_torch.models.convert_hf import load_hf_dir
    from tests.test_torch_hf import unpack_fixture

    d, _, _ = unpack_fixture("hubert", tmp_path / "hf")
    pooled = Wav2Vec2PooledEncoder(PooledConfig(
        reduction_type="mean", d_model=64, num_heads=4, num_layers=2,
        d_ff=128, custom_conv_features=((32, 10, 5), (32, 3, 2))))
    embed.load_pooled_weights(d, pooled)
    state, _ = load_hf_dir(d, ctc=True)
    for k, v in pooled.encoder.state_dict().items():
        assert torch.equal(v, state["encoder." + k]), k
