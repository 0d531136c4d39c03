"""The port's iterators (cxxnet_tpu_torch/io/) against the reference's
(cxxnet_tpu/io/): the same config block over the same files gives the
same batches, bit for bit (data, label, inst_index, num_batch_padd),
over two epochs, so that before_first is exercised.

Data is made from a seed with numpy: MNIST idx files, a CSV and a
raw-tensor imgrec archive (uint8 40x40x3 records, cropped to 3,32,32).
"""

import os
import struct

import numpy as np
import pytest

from cxxnet_tpu.io import create_iterator as ref_create_iterator
from cxxnet_tpu.io import recordio as ref_recordio
from cxxnet_tpu_torch.io import create_iterator
from cxxnet_tpu_torch.io import recordio

N_CSV = 53          # ragged against batch 10
N_MNIST = 250       # ragged against batch 32: the tail is dropped
N_REC = 37          # ragged against batch 8
EPOCHS = 2


def write_idx(dirname, images, labels, prefix="train"):
    img = os.path.join(dirname, "%s-images-idx3-ubyte" % prefix)
    lab = os.path.join(dirname, "%s-labels-idx1-ubyte" % prefix)
    n, h, w = images.shape
    with open(img, "wb") as f:
        f.write(struct.pack(">iiii", 2051, n, h, w))
        f.write(images.astype(np.uint8).tobytes())
    with open(lab, "wb") as f:
        f.write(struct.pack(">ii", 2049, n))
        f.write(labels.astype(np.uint8).tobytes())
    return img, lab


def write_raw_rec(path, n, hw=40, seed=3, nclass=10):
    rng = np.random.RandomState(seed)
    w = recordio.RecordIOWriter(path)
    for i in range(n):
        a = rng.randint(0, 256, (hw, hw, 3)).astype(np.uint8)
        w.write_record(recordio.pack_raw_tensor_record(
            i, float(rng.randint(nclass)), a))
    w.close()
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("io")
    rng = np.random.RandomState(0)
    img, lab = write_idx(str(d), rng.randint(0, 256, (N_MNIST, 28, 28)),
                         rng.randint(0, 10, N_MNIST))
    csv = str(d / "rows.csv")
    x = rng.rand(N_CSV, 12).astype(np.float32)
    y = rng.randint(0, 3, N_CSV)
    with open(csv, "w") as f:
        for i in range(N_CSV):
            f.write(",".join([str(y[i])] + ["%.6f" % v for v in x[i]])
                    + "\n")
    rec = write_raw_rec(str(d / "img.rec"), N_REC)
    return {"img": img, "lab": lab, "csv": csv, "rec": rec}


def epochs(it):
    """Every batch of EPOCHS epochs, as private copies."""
    out = []
    for _ in range(EPOCHS):
        for b in it:
            out.append((np.array(b.data), np.array(b.label),
                        None if b.inst_index is None
                        else np.array(b.inst_index), b.num_batch_padd))
    return out


def run_both(block, global_cfg):
    got = []
    for make in (ref_create_iterator, create_iterator):
        it = make(block, global_cfg)
        try:
            it.init()
            got.append(epochs(it))
        finally:
            it.close()
    return got


def assert_same_batches(ref, port):
    assert len(port) == len(ref) > 0
    for (rd, rl, ri, rp), (pd, pl, pi, pp) in zip(ref, port):
        assert pd.dtype == rd.dtype and pd.shape == rd.shape
        np.testing.assert_array_equal(pd, rd)
        np.testing.assert_array_equal(pl, rl)
        np.testing.assert_array_equal(pi, ri)
        assert pp == rp


def csv_block(f, *extra):
    return [("iter", "csv"), ("filename", f["csv"]),
            ("input_shape", "1,1,12"), ("silent", "1")] + list(extra)


def rec_block(f, *extra):
    return [("iter", "imgrec"), ("path_imgrec", f["rec"]),
            ("input_shape", "3,32,32"), ("silent", "1"),
            ("nthread", "2")] + list(extra)


AUG = (("rand_crop", "1"), ("rand_mirror", "1"),
       ("mean_value", "123,117,104"))

CASES = {
    "mnist_shuffle": lambda f: (
        [("iter", "mnist"), ("path_img", f["img"]),
         ("path_label", f["lab"]), ("shuffle", "1"), ("silent", "1")],
        [("batch_size", "32")]),
    "mnist_nhwc_seed": lambda f: (
        [("iter", "mnist"), ("path_img", f["img"]),
         ("path_label", f["lab"]), ("shuffle", "1"), ("seed_data", "7"),
         ("input_flat", "0"), ("silent", "1")],
        [("batch_size", "32")]),
    "csv_round_batch1": lambda f: (csv_block(f), [("batch_size", "10")]),
    "csv_round_batch0": lambda f: (
        csv_block(f, ("round_batch", "0")), [("batch_size", "10")]),
    "csv_threadbuffer": lambda f: (
        csv_block(f) + [("iter", "threadbuffer")], [("batch_size", "10")]),
    "csv_membuffer": lambda f: (
        csv_block(f, ("round_batch", "0")) + [("iter", "membuffer")],
        [("batch_size", "10")]),
    "imgrec_crop_mirror_mean": lambda f: (
        rec_block(f, *AUG), [("batch_size", "8")]),
    "imgrec_round_batch0": lambda f: (
        rec_block(f, ("round_batch", "0"), *AUG), [("batch_size", "8")]),
    "imgrec_scale": lambda f: (
        rec_block(f, *AUG, ("scale", "0.0078125")),
        [("batch_size", "8")]),
    "imgrec_center_uint8": lambda f: (
        rec_block(f, ("decode_uint8", "1")), [("batch_size", "8")]),
    "imgrec_threadbuffer": lambda f: (
        rec_block(f, *AUG) + [("iter", "threadbuffer")],
        [("batch_size", "8")]),
    "imgrec_membuffer": lambda f: (
        rec_block(f, *AUG) + [("iter", "membuffer")],
        [("batch_size", "8")]),
    "imgrec_shuffle": lambda f: (
        rec_block(f, *AUG, ("shuffle", "1"), ("seed_data", "3")),
        [("batch_size", "8")]),
    "imgrec_per_instance": lambda f: (
        rec_block(f, *AUG, ("augment_vectorize", "0")),
        [("batch_size", "8")]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_iterator_batches_match_reference(files, case):
    block, global_cfg = CASES[case](files)
    ref, port = run_both(block, global_cfg)
    assert_same_batches(ref, port)


def test_round_batch_tails(files):
    """The ragged tail: round_batch = 1 wraps rows from the epoch start
    (their count is num_batch_padd), round_batch = 0 zero-fills them."""
    _, port1 = run_both(*CASES["csv_round_batch1"](files))
    _, port0 = run_both(*CASES["csv_round_batch0"](files))
    per_epoch = len(port1) // EPOCHS
    assert per_epoch == (N_CSV + 9) // 10
    last1, last0 = port1[per_epoch - 1], port0[per_epoch - 1]
    assert last1[3] == last0[3] == 10 - N_CSV % 10
    np.testing.assert_array_equal(last1[0][N_CSV % 10:], port1[0][0][:7])
    assert not last0[0][N_CSV % 10:].any()


def test_imgrec_images_are_the_records(files):
    """A center crop without mean or scale is the record's pixels."""
    it = create_iterator(rec_block(files, ("decode_uint8", "1")),
                         [("batch_size", "8")])
    it.init()
    try:
        b = next(iter(it))
    finally:
        it.close()
    rd = recordio.RecordIOReader(files["rec"])
    try:
        rec = rd.next_record()
    finally:
        rd.close()
    idx, label, arr = recordio.unpack_raw_tensor_record(rec)
    assert b.data.dtype == np.uint8 and b.data.shape == (8, 32, 32, 3)
    np.testing.assert_array_equal(b.data[0], arr[4:36, 4:36])
    assert b.label[0, 0] == label and b.inst_index[0] == idx == 0


def test_recordio_readers_agree(files, tmp_path):
    """The pure-Python reader, the native one (lib/libcxxnet_io.so) and
    the reference's read the same records, whole and in parts, from an
    archive whose payloads hold the magic word (multi-part records)."""
    path = str(tmp_path / "magic.rec")
    rng = np.random.RandomState(5)
    magic = struct.pack("<I", recordio.KMAGIC)
    payloads = [rng.bytes(rng.randint(0, 40)) + magic * rng.randint(0, 3)
                + rng.bytes(rng.randint(0, 9)) for _ in range(60)]
    w = recordio.RecordIOWriter(path, force_python=True)
    for p in payloads:
        w.write_record(p)
    w.close()
    if not recordio.native_available():
        pytest.skip("lib/libcxxnet_io.so is not built (make): only the "
                    "pure-Python reader is here")
    for parts in (1, 3):
        for part in range(parts):
            got = []
            for force in (True, False):
                r = recordio.RecordIOReader(path, part, parts,
                                            force_python=force)
                got.append(list(r))
                r.close()
            r = ref_recordio.RecordIOReader(path, part, parts)
            got.append(list(r))
            r.close()
            assert got[0] == got[1] == got[2]
            if parts == 1:
                assert got[0] == payloads
    # the native writer writes the bytes the Python one does
    npath = str(tmp_path / "native.rec")
    w = recordio.RecordIOWriter(npath)
    for p in payloads:
        w.write_record(p)
    w.close()
    with open(path, "rb") as a, open(npath, "rb") as b:
        assert a.read() == b.read()


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """Seeded JPEGs with their list, one BinaryPage shard, a libsvm
    file and an attachtxt file (tests/test_torch_port_image_io.py)."""
    import test_torch_port_image_io as tio
    d = tmp_path_factory.mktemp("image")
    f = tio.make_image_files(d, shards=1)
    f["svm"] = tio.write_libsvm(str(d / "rows.svm"))
    f["att"] = tio.write_attach(str(d / "extra.txt"), range(0, N_CSV, 2))
    return f


def _kind_block(files, image_files, kind):
    import test_torch_port_image_io as tio
    if kind == "img":
        return tio.img_block(image_files, *AUG)
    if kind == "libsvm":
        return [("iter", "libsvm"), ("filename", image_files["svm"]),
                ("input_shape", "1,1,12"), ("silent", "1")]
    if kind == "attachtxt":
        return csv_block(files) + [("iter", kind),
                                   ("filename", image_files["att"])]
    return tio.imgbin_block(image_files, kind, *AUG)


@pytest.mark.parametrize("kind", ["img", "imgbin", "imgbinx", "imgbinold",
                                  "imginst", "libsvm", "attachtxt"])
def test_iterator_kind_matches_reference(files, image_files, kind):
    """Every iterator type of the image data pipeline builds in the
    port's factory and gives the reference's batches, extra_data
    included, over two epochs."""
    import test_torch_port_image_io as tio
    ref, port = tio.run_both(_kind_block(files, image_files, kind),
                             [("batch_size", "8")])
    tio.assert_same_batches(ref, port)
    if kind == "attachtxt":
        assert port[0][4][0].shape == (8, 3)


@pytest.mark.parametrize("make", [
    lambda f: rec_block(f, ("decode_uint8", "1")), csv_block],
    ids=["imgrec", "csv"])
def test_batch_shard_kind_matches_unsharded(files, make):
    """shard_kind = batch over 2 ranks (global batch 8): each rank's
    batches are the reference's, and the ranks' slices of every global
    batch, concatenated in rank order, give the unsharded record order
    (37 records for imgrec, 53 for csv)."""
    import test_torch_port_image_io as tio
    n = N_REC if make is not csv_block else N_CSV
    ranks = {}
    for mk in (ref_create_iterator, create_iterator):
        ranks[mk] = [tio._indices(make(files) + [
            ("round_batch", "0"), ("shard_kind", "batch"),
            ("shard_global_batch", "8"), ("part_index", str(r)),
            ("num_parts", "2")], mk, 4, n=1) for r in range(2)]
    for a, b in zip(ranks[ref_create_iterator], ranks[create_iterator]):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    port = ranks[create_iterator]
    order = np.concatenate([np.concatenate([r[k] for r in port
                                            if k < len(r)])
                            for k in range(len(port[0]))])
    np.testing.assert_array_equal(order, np.arange(n))


def test_pipeline_wait_stats_match_reference(files):
    """The threadbuffer chain's wait histogram and per-round pipeline
    counters (what the reference's main.py reads under a monitor) count
    the same batches in both packages."""
    from cxxnet_tpu.io import iter_batch as ref_batch
    from cxxnet_tpu_torch.io import iter_batch
    block, global_cfg = CASES["imgrec_threadbuffer"](files)
    got = []
    for make, mod in ((ref_create_iterator, ref_batch),
                      (create_iterator, iter_batch)):
        it = make(block, global_cfg)
        try:
            it.init()
            hist = mod.enable_chain_wait_stats(it)
            n = sum(1 for _ in it)
            snap = mod.pipeline_snapshot(it)
        finally:
            it.close()
        got.append((n, hist.n, snap["batches"], snap["h2d_batches"]))
    assert got[1] == got[0] == ((N_REC + 7) // 8,) * 3 + (0,)
