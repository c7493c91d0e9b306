"""``--distributed true --tensor_parallel 2`` in ``cli.train`` (CTC) and
``cli.pretrain`` on two gloo ranks on the CPU (one model group, data
extent 1), sequence parallelism off and on: the ranks log the same steps
and hold the same whole parameters, which are one process's run on the
same corpus within loss rtol 1e-4 and parameters 1e-6 plus 1e-5 of their
size (SGD; the clip factor carries the gradient norm's relative
rounding, about 1e-6, into every parameter); rank 0 alone writes the
checkpoints, whole. A one-process run's directory resumes under tensor
parallelism, and a tensor-parallel run's in one process, from its
``.pt`` and from its Orbax conversion: one more step from either is the
step of the run it continues, within the same tolerances. Remat and
LayerDrop under sequence parallelism recompute and drop as one process
does."""
import numpy as np
import pytest
import torch

from audio8_tpu_torch.cli import convert_checkpoint
from audio8_tpu_torch.cli import pretrain as pretrain_cli
from audio8_tpu_torch.cli import train as train_cli
from audio8_tpu_torch.models.text import read_vocab_list
from tests.test_torch_dp_cli import (SGD, _default_offsets,  # noqa: F401
                                     _pretrain_args, _same_files)
from tests.test_torch_pretrain_cli import write_audio_corpus
from tests.test_torch_threads import cap_torch_threads
from tests.test_torch_train_cli import (SMALL, _train_args,
                                        write_letter_corpus)
from tests.torch_dp_ranks import kept_offsets, run_cli_ranks, subdir

cap_torch_threads()

TP = ["--tensor_parallel", "2"]
SP = ["--sequence_parallel", "true"]
REMAT = ["--remat", "true", "--layer_drop", "0.5"]
LOSS_RTOL = 1e-4
PARAM_ATOL, PARAM_RTOL = 1e-6, 1e-5


def check_tp_runs(two, one_log, one_params, keys=("loss",)):
    """The ranks bitwise equal to each other (logs but for the seconds,
    whole parameters), and one process's run within the tolerances."""
    for k, v in two[0]["params"].items():
        assert torch.equal(v, two[1]["params"][k]), k
    assert two[0]["log"] == [dict(r, seconds=two[0]["log"][i]["seconds"])
                             for i, r in enumerate(two[1]["log"])]
    for key in keys:
        np.testing.assert_allclose([r[key] for r in two[0]["log"]],
                                   [r[key] for r in one_log],
                                   rtol=LOSS_RTOL, err_msg=key)
    assert set(two[0]["params"]) == set(one_params)
    for k, v in one_params.items():
        np.testing.assert_allclose(two[0]["params"][k].numpy(),
                                   v.detach().numpy(), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


def _moved(args, basedir, steps=None, restart=None):
    """``args`` with another ``--basedir`` (and ``--train_steps``, and a
    ``--restart_from``)."""
    args = list(args)
    args[args.index("--basedir") + 1] = basedir
    if steps is not None:
        args[args.index("--train_steps") + 1] = str(steps)
    return args + ([] if restart is None else ["--restart_from", restart])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process's run of each trainer first, then on one pair of ranks
    both trainers at TP 2 (SP off, on) and the two resumes: the
    one-process CTC run resumed under TP, and (in the test) the TP run
    resumed in one process."""
    root = tmp_path_factory.mktemp("tp_cli")
    with kept_offsets():
        train_c = write_letter_corpus(subdir(root, "train_corpus"))
        pre_c = write_audio_corpus(subdir(root, "pretrain_corpus"))
        train_args = _train_args(train_c, str(root / "train1")) + SGD
        pre_args = _pretrain_args(pre_c, str(root / "pretrain1"))
        one = {"train": train_cli.train(train_args),
               "pretrain": pretrain_cli.train(pre_args)}
        one = {k: (s.log, {n: v.detach().clone() for n, v in
                           s.model.state_dict().items()})
               for k, s in one.items()}
        jobs = [("audio8_tpu_torch.cli.train",
                 _moved(train_args, str(root / "train_tp")) + TP),
                ("audio8_tpu_torch.cli.train",
                 _moved(train_args, str(root / "train_sp")) + TP + SP),
                ("audio8_tpu_torch.cli.pretrain",
                 _moved(pre_args, str(root / "pretrain_tp")) + TP),
                ("audio8_tpu_torch.cli.pretrain",
                 _moved(pre_args, str(root / "pretrain_sp")) + TP + SP),
                ("audio8_tpu_torch.cli.train",
                 _moved(train_args, str(root / "resumed_tp"), 4,
                        str(root / "train1")) + TP),
                ("audio8_tpu_torch.cli.train",
                 _moved(train_args, str(root / "remat_sp")) + TP + SP
                 + REMAT)]
        results = run_cli_ranks(jobs, 2, root / "ranks")
        remat = train_cli.train(_moved(train_args, str(root / "remat1"))
                                + REMAT)
        one["remat"] = (remat.log, {n: v.detach().clone() for n, v in
                                    remat.model.state_dict().items()})
        yield root, train_args, one, dict(zip(
            ("train_tp", "train_sp", "pretrain_tp", "pretrain_sp",
             "resumed_tp", "remat_sp"), results))


@pytest.mark.parametrize("name", ["train_tp", "train_sp"])
def test_train_tp_matches_one_process(runs, name):
    root, _, one, results = runs
    two = results[name]
    check_tp_runs(two, *one["train"], keys=("loss", "audio_s"))
    assert [r["frozen"] for r in two[0]["log"]] == [True, True, False]
    _same_files(root / "train1", root / name)


@pytest.mark.parametrize("name", ["pretrain_tp", "pretrain_sp"])
def test_pretrain_tp_matches_one_process(runs, name):
    _, _, one, results = runs
    check_tp_runs(results[name], *one["pretrain"],
                  keys=("loss", "code_perplexity", "accuracy",
                        "grad_norm"))


def test_checkpoints_resume_across_layouts(runs, tmp_path):
    """The one-process run's step 3 resumed at TP 2 and the TP run's step
    3 resumed in one process take the same fourth step."""
    root, train_args, _, results = runs
    state = train_cli.train(_moved(train_args, str(tmp_path / "resumed1"),
                                   4, str(root / "train_tp")))
    assert state.log[0]["step"] == 4 == results["resumed_tp"][0]["log"][0][
        "step"]
    check_tp_runs(results["resumed_tp"], state.log,
                  state.model.state_dict(), keys=("loss",))


def test_remat_and_layer_drop_under_sequence_parallelism(runs):
    _, _, one, results = runs
    check_tp_runs(results["remat_sp"], *one["remat"],
                  keys=("loss", "audio_s"))


def test_orbax_conversion_of_a_tp_checkpoint_resumes(runs, tmp_path):
    """The TP run's step-3 ``.pt`` converted to an Orbax TrainState
    (``cli.convert_checkpoint``) resumes in one process at step 3 and
    takes the fourth step the TP run's resumes take."""
    root, train_args, _, results = runs
    labels = len(read_vocab_list(str(root / "train_corpus" /
                                     "dict.ltr.txt")))
    out = convert_checkpoint.main([
        "--input", str(root / "train_tp" / "checkpoint-step-3.pt"),
        "--output", str(tmp_path / "orbax" / "checkpoint"),
        "--output_format", "orbax", "--ctc", "true", "--num_labels",
        str(labels), *SMALL])
    state = train_cli.train(_moved(train_args, str(tmp_path / "resumed"),
                                   4, out))
    assert state.log[0]["step"] == 4
    check_tp_runs(results["resumed_tp"], state.log,
                  state.model.state_dict(), keys=("loss",))
