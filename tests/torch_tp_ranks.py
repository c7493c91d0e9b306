"""Gloo ranks on the CPU for the tensor-parallel tests
(``tests/test_torch_tp_*.py``): :func:`run_tp_ranks` spawns ``world``
processes laid out as ``(world // tp, tp)`` (``parallel/sharding.py:
make_groups``) and returns each rank's result; the step runners run the
port's CTC and pretraining steps on a rank's data block with the model
split over its model group, or, with ``world`` 1, whole in the calling
process. This module imports torch and the port only: the spawned ranks
never import JAX."""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from tests.torch_dp_ranks import LR, _offsets, _set_offsets


def _entry(rank, world, tp, init_file, out_dir, jobs, offsets):
    from audio8_tpu_torch.parallel.sharding import make_groups

    _set_offsets(offsets)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        make_groups(tp)
        out = [worker(rank, world, tp, *args) for worker, args in jobs]
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_tp_ranks(jobs, world: int, tp: int, tmp_path) -> list:
    """Each ``worker(rank, world, tp, *args)`` of ``jobs`` in turn on
    ``world`` spawned gloo ranks with model groups of ``tp``; per rank, the
    list of the jobs' results."""
    import torch.multiprocessing as mp

    out_dir = str(tmp_path)
    os.makedirs(out_dir, exist_ok=True)
    mp.start_processes(_entry, args=(world, tp, os.path.join(out_dir, "init"),
                                     out_dir, jobs, _offsets()),
                       nprocs=world, start_method="spawn", join=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
            for r in range(world)]


def _sharded_state(model, optim: str = "sgd"):
    """The model's ``TrainState``, split over the rank's model group (when
    one runs) as a trainer splits it; returns ``(state, data group)``."""
    from audio8_tpu_torch.parallel.sharding import data_group
    from audio8_tpu_torch.parallel import shard_state
    from audio8_tpu_torch.train.optim import (TrainState, create_lrs,
                                              create_optimizer)

    state = TrainState(model, create_optimizer(
        create_lrs(LR, 10, sched_type="constant", warmup_steps=0), optim))
    group = data_group()
    shard_state(state, group)
    return state, group


def whole_params(state) -> dict:
    """The state's whole parameters (gathered over the model group)."""
    from audio8_tpu_torch.parallel import full_state

    with full_state(state):
        return {k: v.detach().clone()
                for k, v in state.model.state_dict().items()}


def own_params(model) -> dict:
    """The rank's own (split or replicated) parameters."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def ctc_tp_steps(rank, world, tp, cfg, params, batch, seed_lists,
                 dtype=torch.float32, clip=25.0):
    """CTC steps (unfrozen, summed loss, SGD) on the data block of
    ``batch`` that rank ``rank`` belongs to, the model split over its
    model group; one step per list of replayed seeds, or ``seed_lists``
    steps (an int) drawing from one generator seeded alike on every
    rank. Returns the global losses, gradient norms, the whole
    parameters and the rank's own."""
    from audio8_tpu_torch.config import AcousticConfig
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
    from audio8_tpu_torch.ops.hashrand import SeedReplay
    from audio8_tpu_torch.parallel.sharding import (global_sum_scalars,
                                                    row_block)
    from audio8_tpu_torch.train.steps import make_ctc_steps

    model = Wav2Vec2AcousticModel(AcousticConfig(**cfg), dtype)
    model.load_state_dict(params, strict=True)
    state, group = _sharded_state(model) if world > 1 else \
        (_one_state(model), None)
    grad_fn, update_fn, _ = make_ctc_steps(model, clip=clip, group=group)
    n_real = int((batch["signal_lengths"] > 0).sum())
    lo, b_local, _ = row_block(n_real, batch["signal"].shape[0],
                               rank // tp, world // tp)
    local = {k: torch.from_numpy(v[lo:lo + b_local])
             for k, v in batch.items()}
    local["row_offset"] = lo
    losses, gnorms = [], []
    gen = torch.Generator().manual_seed(7)
    for seeds in ([None] * seed_lists if isinstance(seed_lists, int)
                  else seed_lists):
        replay = gen if seeds is None else SeedReplay(seeds)
        loss, grads, rows, _ = grad_fn(local, replay, freeze=False)
        if seeds is not None and replay.remaining:
            raise RuntimeError(f"{replay.remaining} seeds not drawn")
        state, gnorm = update_fn(state, grads, rows)
        losses.append(float(global_sum_scalars([float(loss)], group)[0]))
        gnorms.append(float(gnorm))
    return {"loss": losses, "gnorm": gnorms, "params": whole_params(state),
            "own": own_params(model)}


def _one_state(model):
    from tests.torch_dp_ranks import _state

    return _state(model)


def pretrain_tp_steps(rank, world, tp, cfg, params, signal, step_seeds,
                      dtype=torch.float32):
    """Contrastive pretraining steps (SGD) on the data block of the dense
    ``signal``, the model split over the rank's model group; ``step_seeds``
    per step ``(dropout seeds, (mask, gumbel, negatives))``. Returns the
    losses, gradient norms, whole parameters and the rank's own."""
    from audio8_tpu_torch.config import PretrainConfig
    from audio8_tpu_torch.models.wav2vec2 import PretrainSeeds, Wav2Vec2Model
    from audio8_tpu_torch.ops.hashrand import SeedReplay
    from audio8_tpu_torch.train.steps import make_pretrain_steps

    model = Wav2Vec2Model(PretrainConfig(**cfg), dtype)
    model.load_state_dict(params, strict=True)
    state, group = _sharded_state(model) if world > 1 else \
        (_one_state(model), None)
    step, _ = make_pretrain_steps(model, clip=1.0,
                                  n_negatives=cfg["n_negatives"],
                                  group=group)
    data_world = world // tp
    b_local = signal.shape[0] // data_world
    lo = (rank // tp) * b_local
    x = torch.from_numpy(signal[lo:lo + b_local])
    out = {k: [] for k in ("loss", "gnorm")}
    for drop, (mask, gumbel, negatives) in step_seeds:
        replay = SeedReplay(drop)
        state, m = step(state, x, PretrainSeeds(mask=mask, gumbel=gumbel,
                                                negatives=negatives),
                        replay, lo)
        if replay.remaining:
            raise RuntimeError(f"{replay.remaining} seeds not drawn")
        out["loss"].append(float(m["loss"]))
        out["gnorm"].append(float(m["grad_norm"]))
    out["params"] = whole_params(state)
    out["own"] = own_params(model)
    return out


def norm_of_split_grads(rank, world, tp, cfg, params, batch):
    """One CTC gradient on the rank's model group: the global norm of
    its split gradients (``TensorShards.global_norm``) and, on the same
    rank, ``train/optim.py:global_norm`` of the same gradients gathered
    whole."""
    from audio8_tpu_torch.config import AcousticConfig
    from audio8_tpu_torch.models.wav2vec2 import Wav2Vec2AcousticModel
    from audio8_tpu_torch.train.optim import global_norm
    from audio8_tpu_torch.train.steps import make_ctc_steps

    model = Wav2Vec2AcousticModel(AcousticConfig(**cfg))
    model.load_state_dict(params, strict=True)
    state, group = _sharded_state(model)
    grad_fn, _, _ = make_ctc_steps(model, group=group)
    local = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, grads, _, _ = grad_fn(local, None, freeze=False)
    grads = [grads[n] for n in state.names]
    shards = state.tensor_shards
    whole = [g if shards.dim_of(p) is None else shards.gather(
        g, shards.dim_of(p)) for g, p in zip(grads, state.params)]
    return {"split": float(shards.global_norm(grads, state.params)),
            "whole": float(global_norm(whole))}


def _replayed_steps(grad_fn, update_fn, state, group, batch, seed_lists,
                    **flags):
    """One step per list of replayed dropout seeds (every seed drawn);
    the global losses and gradient norms."""
    from audio8_tpu_torch.ops.hashrand import SeedReplay
    from audio8_tpu_torch.parallel.sharding import global_sum_scalars

    losses, gnorms = [], []
    for seeds in seed_lists:
        replay = SeedReplay(seeds)
        loss, *_, grads, rows, _ = grad_fn(batch, replay, **flags)
        if replay.remaining:
            raise RuntimeError(f"{replay.remaining} seeds not drawn")
        state, gnorm = update_fn(state, grads, rows)
        losses.append(float(global_sum_scalars([float(loss)], group)[0]))
        gnorms.append(float(gnorm))
    return losses, gnorms


def seq2seq_tp_steps(rank, world, tp, enc, dec, params, batch, seed_lists):
    """Unfrozen seq2seq steps (SGD, clip 25) on the whole ``batch`` (one
    data rank), the encoder and decoder split over the model group, one
    step per list of replayed seeds. Returns the losses, gradient norms
    and the whole parameters."""
    from audio8_tpu_torch.config import DecoderConfig, EncoderConfig
    from audio8_tpu_torch.models.seq2seq import Seq2Seq
    from audio8_tpu_torch.train.steps import make_seq2seq_steps

    model = Seq2Seq(EncoderConfig(**enc), DecoderConfig(**dec))
    model.load_state_dict(params, strict=True)
    state, group = _sharded_state(model)
    grad_fn, update_fn, _, _ = make_seq2seq_steps(model, clip=25.0,
                                                  group=group)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses, gnorms = _replayed_steps(grad_fn, update_fn, state, group, tb,
                                     seed_lists, freeze=False)
    return {"loss": losses, "gnorm": gnorms, "params": whole_params(state)}


def paired_tp_steps(rank, world, tp, audio, text, stack, out_dim,
                    init_temp, params, batch, seed_lists):
    """Unfrozen paired (CLIP) steps (SGD, clip 25) on the whole ``batch``
    (one data rank), both towers split over the model group, one step
    per list of replayed seeds. Returns the losses, gradient norms and
    the whole parameters."""
    from audio8_tpu_torch.config import PooledConfig, TextEncoderConfig
    from audio8_tpu_torch.models.dual_encoder import (DualEncoderModel,
                                                      PairedModule,
                                                      SymmetricCLIPLoss)
    from audio8_tpu_torch.train.steps import make_paired_steps

    module = PairedModule(
        DualEncoderModel(PooledConfig(**audio), TextEncoderConfig(**text),
                         stack, out_dim), SymmetricCLIPLoss(init_temp))
    module.load_state_dict(params, strict=True)
    state, group = _sharded_state(module)
    grad_fn, update_fn, _ = make_paired_steps(module, clip=25.0, group=group)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses, gnorms = _replayed_steps(grad_fn, update_fn, state, group, tb,
                                     seed_lists, freeze_audio=False,
                                     freeze_text=False)
    return {"loss": losses, "gnorm": gnorms, "params": whole_params(state)}


def transducer_tp_steps(rank, world, tp, cfg, params, batch, seed_lists):
    """Unfrozen RNN-T steps (SGD, clip 25) on the whole ``batch`` (one
    data rank), the encoder split over the model group (the predictor
    and joint replicated), one step per list of replayed seeds."""
    from audio8_tpu_torch.config import TransducerConfig
    from audio8_tpu_torch.models.transducer import Transducer
    from audio8_tpu_torch.train.steps import make_transducer_steps

    model = Transducer(TransducerConfig(**cfg))
    model.load_state_dict(params, strict=True)
    state, group = _sharded_state(model)
    grad_fn, update_fn, _, _ = make_transducer_steps(model, clip=25.0,
                                                     group=group)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses, gnorms = _replayed_steps(grad_fn, update_fn, state, group, tb,
                                     seed_lists, freeze=False)
    return {"loss": losses, "gnorm": gnorms, "params": whole_params(state)}


def ssl_tp_steps(rank, world, tp, kind, cfg, params, batch, step_seeds):
    """HuBERT or data2vec (``kind``) steps (SGD, clip 1) on the whole
    ``batch`` (one data rank), the model (and data2vec's teacher, a copy
    of it) split over the model group; ``step_seeds`` per step
    ``(dropout seeds, key seeds)``. Returns the losses, gradient norms
    and the whole parameters (and teacher)."""
    from audio8_tpu_torch.config import (Data2VecPretrainConfig,
                                         HubertPretrainConfig)
    from audio8_tpu_torch.models.data2vec import Data2VecAudioModel
    from audio8_tpu_torch.models.hubert import (HubertPretrainModel,
                                                HubertSeeds)
    from audio8_tpu_torch.ops.hashrand import SeedReplay
    from audio8_tpu_torch.parallel import full_state, shard_like
    from audio8_tpu_torch.train.steps import (make_data2vec_steps,
                                              make_hubert_steps)

    if kind == "hubert":
        model = HubertPretrainModel(HubertPretrainConfig(**cfg))
    else:
        model = Data2VecAudioModel(Data2VecPretrainConfig(**cfg))
        teacher = Data2VecAudioModel(Data2VecPretrainConfig(**cfg))
        teacher.load_state_dict(params, strict=True)
    model.load_state_dict(params, strict=True)
    state, group = _sharded_state(model)
    if kind == "hubert":
        step, _ = make_hubert_steps(model, clip=1.0, group=group)
    else:
        shard_like(teacher, state)
        step, _ = make_data2vec_steps(model, teacher, clip=1.0, group=group)
    tb = {k: None if v is None else torch.from_numpy(v)
          for k, v in batch.items()}
    out = {"loss": [], "gnorm": []}
    for drop, keys in step_seeds:
        replay = SeedReplay(drop)
        seeds = HubertSeeds(*keys) if kind == "hubert" else keys[0]
        state, m = step(state, tb, seeds, replay)
        if replay.remaining:
            raise RuntimeError(f"{replay.remaining} seeds not drawn")
        out["loss"].append(float(m["loss"]))
        out["gnorm"].append(float(m["grad_norm"]))
    out["params"] = whole_params(state)
    if kind == "data2vec":
        with full_state(teacher):
            out["teacher"] = own_params(teacher)
    return out
