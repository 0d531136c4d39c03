"""The north-star gate through the port's CLI: ``example/MNIST/MNIST.conf``
run by ``cxxnet_tpu_torch.main`` with ``dev = cpu`` reaches a best
test-error below 0.03 in 10 rounds, on the data of the reference's gate
(``tests/test_mnist_e2e.py``: 12,000 train and 1,500 test digits that
``example/MNIST/get_data.synthesize`` makes with seed 1).
"""

import os
import re
import sys

import pytest
import torch

from cxxnet_tpu_torch.main import LearnTask

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MNIST_DIR = os.path.join(REPO, "example", "MNIST")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The port's CPU ops on one thread: at these sizes more threads
    only contend with each other and with the other test workers'."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _prepare(tmp_path, n_train=12000, n_test=1500):
    """The reference gate's data (tests/test_mnist_e2e.py)."""
    pytest.importorskip("sklearn")
    pytest.importorskip("cv2")
    sys.path.insert(0, MNIST_DIR)
    try:
        from get_data import synthesize
    finally:
        sys.path.remove(MNIST_DIR)
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    synthesize(str(data_dir), n_train=n_train, n_test=n_test, seed=1)
    return data_dir


def test_port_mnist_mlp_accuracy(tmp_path, monkeypatch, capsys):
    _prepare(tmp_path)
    monkeypatch.chdir(tmp_path)
    rc = LearnTask().run([os.path.join(MNIST_DIR, "MNIST.conf"),
                          "dev=cpu", "num_round=10"])
    out = capsys.readouterr().out
    assert rc == 0, out
    errs = [float(m) for m in re.findall(r"test-error:([0-9.eE+-]+)", out)]
    assert len(errs) == 10, out
    train = [float(m) for m in re.findall(r"train-error:([0-9.eE+-]+)",
                                          out)]
    assert len(train) == 10 and train[-1] < train[0]
    # the reference MLP's target is ~98%: gate at error < 0.03
    assert min(errs) < 0.03, "MLP test error %.4f (want < 0.03); " \
        "curve=%s" % (min(errs), errs)
