"""The shipped configs of the image data pipeline through both CLIs:
``example/ImageNet/kaiming.conf`` (``iter = imginst``, a mean image,
the crop-resize keys) and ``example/kaggle_bowl/bowl.conf`` /
``pred.conf`` (``iter = img``), narrowed, each run in process with
``dev = cpu`` from one snapshot the reference writes.

Narrowing keeps every layer, pad, stride and data key and cuts the
widths to an eighth (kaiming: convs 8 / 16 / 32, the 2304-wide conv 64,
fc 64, 10 classes; bowl: convs 6 / 12 / 16, fc 32, 11 classes), batch
4, dropout threshold 0. kaiming's net needs its 224-px input (its SPP
k6 pool fits from 208 px), and ``task = pred``'s deterministic center
crop needs images at least that size: its seeded JPEGs are 232 px
(all one size, which the mean image needs); bowl's are the 48-px gray
blobs of ``example/kaggle_bowl/synth_data.py``.

Held: the pred files (classes) and get_weight files identical; the mean
image each package computes over the train block identical; pred.conf's
``pred_raw`` rows within rtol 1e-5 / atol 1e-6 with the same argmax;
kaiming.conf's train block (imginst, crop-resize with aspect jitter,
rand_crop / rand_mirror, the mean image, threadbuffer) batch for batch,
bit for bit over two epochs. bowl.conf's ``dtype = bfloat16`` pred runs
the reference's steps with excess precision off, as the port's eager
ops round (``test_torch_port_alexnet._as_the_port_runs``).

The reference draws each weight shape with ``jax.random``, whose
threefry program XLA:CPU compiles in about a second a shape, also when
a snapshot is loaded (its trainer initializes before it loads). The
module draws the reference's initial weights from numpy instead
(``test_torch_port_image_io.numpy_init``, the same bounds): the snapshot is still the
reference's, written by its ``save_model``.
"""

import os

import numpy as np
import pytest
import torch

from cxxnet_tpu.io import create_iterator as ref_create_iterator
from cxxnet_tpu.layers.base import LayerParam
from cxxnet_tpu.main import LearnTask as RefTask
from cxxnet_tpu.nnet.trainer import NetTrainer as RefTrainer
from cxxnet_tpu.utils.config import parse_config_file
from cxxnet_tpu_torch.io import create_iterator
from cxxnet_tpu_torch.main import LearnTask
from cxxnet_tpu_torch.utils.config import split_sections
import test_torch_port_image_io as tio
from test_torch_port_alexnet import _as_the_port_runs
from test_torch_port_main import run_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KAIMING = os.path.join(ROOT, "example", "ImageNet", "kaiming.conf")
BOWL = os.path.join(ROOT, "example", "kaggle_bowl")
KAIMING_NARROW = (("nchannel = 2304", "nchannel = 64"),
                  ("nchannel = 256", "nchannel = 32"),
                  ("nchannel = 128", "nchannel = 16"),
                  ("nchannel = 64\n", "nchannel = 8\n"),
                  ("nhidden = 4096", "nhidden = 64"),
                  ("nhidden = 1000", "nhidden = 10"),
                  ("batch_size = 128", "batch_size = 4"),
                  ("threshold = 0.5", "threshold = 0"))
BOWL_NARROW = (("nchannel = 48", "nchannel = 6"),
               ("nchannel = 96", "nchannel = 12"),
               ("nchannel = 128", "nchannel = 16"),
               ("nhidden = 256", "nhidden = 32"),
               ("nhidden = 121", "nhidden = 11"),
               ("batch_size = 64", "batch_size = 4"),
               ("threshold = 0.5", "threshold = 0"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def _fast_reference_init():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(LayerParam, "rand_init_weight", tio.numpy_init)
        yield


def _narrowed(src, pairs, dst):
    with open(src) as f:
        text = f.read()
    for old, new in pairs:
        assert old in text, old
        text = text.replace(old, new)
    with open(dst, "w") as f:
        f.write(text)
    return dst


def _in_dirs(base, names, tasks):
    """Run each (argv) of ``tasks`` through the reference's CLI in
    base/ref and the port's in base/port (each dir links ``names``)."""
    for pkg, cls in (("ref", RefTask), ("port", LearnTask)):
        d = os.path.join(base, pkg)
        os.makedirs(d, exist_ok=True)
        for n in names:
            os.symlink(os.path.join(base, n), os.path.join(d, n))
        old = os.getcwd()
        os.chdir(d)
        try:
            for argv in tasks:
                with pytest.MonkeyPatch.context() as mp:
                    _as_the_port_runs(mp)
                    rc, out = run_cli(cls, argv)
                assert rc == 0, out
        finally:
            os.chdir(old)


def _read(base, pkg, name, mode="r"):
    with open(os.path.join(base, pkg, name), mode) as f:
        return f.read()


# --------------------------------------------------------------- kaiming

@pytest.fixture(scope="module")
def kaiming(tmp_path_factory):
    """The narrowed kaiming.conf, its imginst archives (6 train, 4 val
    232-px JPEGs) and the reference's snapshot."""
    import cv2
    d = str(tmp_path_factory.mktemp("kaiming"))
    rng = np.random.RandomState(0)
    os.makedirs(os.path.join(d, "imgs"))
    for name, n in (("train", 6), ("val", 4)):
        rows = []
        for i in range(n):
            fn = "%s%02d.jpg" % (name, i)
            assert cv2.imwrite(os.path.join(d, "imgs", fn), rng.randint(
                0, 256, (232, 232, 3)).astype(np.uint8))
            rows.append((i, (rng.randint(10),), fn))
        tio.write_list(os.path.join(d, name + ".lst"), rows, 1)
        tio.write_bin(os.path.join(d, name + ".bin"), d, rows)
    conf = _narrowed(KAIMING, KAIMING_NARROW,
                     os.path.join(d, "kaiming.conf"))
    t = RefTrainer(parse_config_file(conf))
    t.init_model()
    t.save_model(os.path.join(d, "s0.model.npz"))
    return d


def test_kaiming_conf_pred_and_weights_match_reference(kaiming):
    _in_dirs(kaiming, ("train.lst", "train.bin", "val.lst", "val.bin",
                       "kaiming.conf", "s0.model.npz"),
             [["kaiming.conf", "dev=cpu", "task=pred",
               "model_in=s0.model.npz", "pred=pred.txt"],
              ["kaiming.conf", "dev=cpu", "task=get_weight",
               "model_in=s0.model.npz", "weight_layer=conv1",
               "weight_filename=w.txt"]])
    pred = _read(kaiming, "ref", "pred.txt")
    assert _read(kaiming, "port", "pred.txt") == pred
    assert len(pred.splitlines()) == 6
    for name in ("mean_224.bin.npy", "w.txt"):
        assert _read(kaiming, "port", name, "rb") == \
            _read(kaiming, "ref", name, "rb")


def test_kaiming_conf_train_block_matches_reference(kaiming, tmp_path):
    """The conf's train data block as shipped (only the data paths and
    the batch narrowed), through both factories in directories of their
    own, so each computes its mean image."""
    blocks, _ = split_sections(parse_config_file(
        os.path.join(kaiming, "kaiming.conf")))
    block = next(b["cfg"] for b in blocks if b["kind"] == "data")
    assert ("min_crop_size", "192") in block
    got = []
    for pkg, make in (("ref", ref_create_iterator), ("port", create_iterator)):
        d = tmp_path / pkg
        d.mkdir()
        for n in ("train.lst", "train.bin"):
            os.symlink(os.path.join(kaiming, n), str(d / n))
        old = os.getcwd()
        os.chdir(str(d))
        try:
            it = make(block, [("batch_size", "4"),
                              ("input_shape", "3,224,224")])
            try:
                it.init()
                got.append(tio.epochs(it))
            finally:
                it.close()
        finally:
            os.chdir(old)
    tio.assert_same_batches(*got)
    assert got[1][0][0].shape == (4, 224, 224, 3)


# ------------------------------------------------------------------ bowl

@pytest.fixture(scope="module")
def bowl(tmp_path_factory):
    """The narrowed bowl.conf, synth_data.py's blobs (11 classes x 1
    train, 6 test) with their lists, and the reference's snapshot at
    ``models/0030.model.npz`` (where pred.conf reads it)."""
    import cv2
    d = str(tmp_path_factory.mktemp("bowl"))
    rng = np.random.RandomState(0)
    os.makedirs(os.path.join(d, "imgs"))
    rows = {"train": [], "test": []}
    for name, n in (("train", 11), ("test", 6)):
        for i in range(n):
            ci = i if name == "train" else rng.randint(11)
            img = rng.randint(0, 40, (48, 48)).astype(np.uint8)
            y, x = 3 + 3 * (ci % 11), 3 + 3 * (ci // 11)
            img[y:y + 10, x:x + 10] = 220 - rng.randint(0, 30)
            fn = "imgs/%s%03d.jpg" % (name, i)
            assert cv2.imwrite(os.path.join(d, fn), img)
            rows[name].append((i, (ci if name == "train" else 0,), fn))
        tio.write_list(os.path.join(d, name + ".lst"), rows[name], 1)
    conf = _narrowed(os.path.join(BOWL, "bowl.conf"), BOWL_NARROW,
                     os.path.join(d, "bowl.conf"))
    t = RefTrainer(parse_config_file(conf))
    t.init_model()
    os.makedirs(os.path.join(d, "models"))
    t.save_model(os.path.join(d, "models", "0030.model.npz"))
    return d


def test_bowl_and_pred_conf_match_reference(bowl):
    """bowl.conf: task = pred (the train block's deterministic fallback,
    bf16) and get_weight; pred.conf as shipped (``task = pred_raw`` over
    test.lst from models/0030.model.npz)."""
    _in_dirs(bowl, ("train.lst", "test.lst", "imgs", "bowl.conf", "models"),
             [["bowl.conf", "dev=cpu", "task=pred",
               "model_in=models/0030.model.npz", "pred=pred.txt"],
              ["bowl.conf", "dev=cpu", "task=get_weight",
               "model_in=models/0030.model.npz", "weight_layer=layer13",
               "weight_filename=w.txt"],
              [os.path.join(BOWL, "pred.conf"), "dev=cpu"]])
    pred = _read(bowl, "ref", "pred.txt")
    assert _read(bowl, "port", "pred.txt") == pred
    assert len(pred.splitlines()) == 11
    assert _read(bowl, "port", "w.txt", "rb") == \
        _read(bowl, "ref", "w.txt", "rb")
    raw = {pkg: np.loadtxt(os.path.join(bowl, pkg, "test.txt"), ndmin=2)
           for pkg in ("ref", "port")}
    assert raw["ref"].shape == (6, 11)
    np.testing.assert_allclose(raw["port"], raw["ref"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(raw["port"].argmax(1),
                                  raw["ref"].argmax(1))
