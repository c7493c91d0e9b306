"""``--distributed true`` in ``cli.pretrain_hubert`` (on the port's
MFCC cluster targets) and ``cli.pretrain_data2vec`` on two gloo ranks on
the CPU: bitwise-equal ranks, the global step of one process on the same
corpus (HuBERT's supervised batches keep their real rows whatever the
snap adds, data2vec's dense batches hold 2 rows either way at a budget of
16 000 samples),
the same checkpoint files (rank 0's; data2vec's teacher too). One pair
of ranks runs both trainers in turn. SGD; tolerances as
``tests/test_torch_dp_cli.py``'s."""
import pytest

from audio8_tpu_torch.cli import (cluster_targets, pretrain_data2vec,
                                  pretrain_hubert)
from tests.test_torch_dp_cli import (SGD, _check_runs,  # noqa: F401
                                     _default_offsets, _same_files)
from tests.test_torch_ssl_cli import D2V, HUBERT
from tests.test_torch_ssl_cli import corpus as ssl_corpus  # noqa: F401
from tests.test_torch_threads import cap_torch_threads
from tests.torch_dp_ranks import kept_offsets, run_cli_ranks

cap_torch_threads()


@pytest.fixture(scope="module")
def km(ssl_corpus):
    root, _ = ssl_corpus
    assert cluster_targets.main([
        "--root_dir", str(root / "port"), "--manifests", "train.tsv",
        "valid.tsv", "--num_clusters", "4", "--fit_frames", "2000",
        "--kmeans_iters", "5", "--device", "cpu"]) == 0
    return root / "port"


def _hubert_args(km, basedir):
    return HUBERT + SGD + [
        "--device", "cpu", "--root_dir", str(km), "--train_dataset",
        "train.tsv", "--valid_dataset", "valid.tsv", "--basedir",
        basedir, "--train_steps", "2", "--steps_per_checkpoint", "2"]


def _d2v_args(ssl_corpus, basedir):
    root, _ = ssl_corpus
    return D2V + SGD + [
        "--tokens_per_batch", "16000",
        "--device", "cpu", "--manifest_dir", str(root / "port"),
        "--basedir", basedir, "--train_steps", "2",
        "--steps_per_checkpoint", "2"]


@pytest.fixture(scope="module")
def ranks(km, ssl_corpus, tmp_path_factory):
    """Both trainers' 2-rank runs on one pair of ranks; the special-token
    ids stay as the corpora left them (the ranks' start) until the
    module's tests end."""
    root = tmp_path_factory.mktemp("dp_cli_ssl")
    with kept_offsets():
        jobs = [("audio8_tpu_torch.cli.pretrain_hubert",
                 _hubert_args(km, str(root / "hubert2"))),
                ("audio8_tpu_torch.cli.pretrain_data2vec",
                 _d2v_args(ssl_corpus, str(root / "d2v2")))]
        hubert, d2v = run_cli_ranks(jobs, 2, root / "ranks")
        yield root, {"hubert": hubert, "data2vec": d2v}


def test_hubert_two_ranks_match_one_process(km, ranks, tmp_path):
    root, runs = ranks
    one = pretrain_hubert.train(_hubert_args(km, str(tmp_path / "run1")))
    _check_runs(runs["hubert"], one, ("loss", "acc_masked", "grad_norm",
                                      "audio_s"))
    _same_files(tmp_path / "run1", root / "hubert2")


def test_data2vec_two_ranks_match_one_process(ssl_corpus, ranks, tmp_path):
    root, runs = ranks
    two = runs["data2vec"]
    one, _ = pretrain_data2vec.train(_d2v_args(ssl_corpus,
                                               str(tmp_path / "run1")))
    assert [r["rows"] for r in two[0]["log"]] == \
        [r["rows"] for r in one.log] == [2, 2]
    _check_runs(two, one, ("loss", "target_std", "pred_std", "grad_norm"))
    _same_files(tmp_path / "run1", root / "d2v2")
