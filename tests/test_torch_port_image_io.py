"""The port's image data pipeline (cxxnet_tpu_torch/io/: binpage,
iter_imgbin, iter_img, iter_libsvm, shard, iter_attach) against the
reference's, and the staging of batches on the device
(``NetTrainer.device_put_batch`` behind ``PrefetchIterator``).

Data is made from a seed with numpy: JPEGs of at most 28 px written by
``cv2`` (decoded by ``cv2`` in both packages), packed into BinaryPage
archives with their list files, a libsvm text file, a CSV, a raw-tensor
imgrec archive and an attachtxt file. Iterators are held bit for bit
over two epochs (data, label, inst_index, num_batch_padd, extra_data).
The ``extra_data_num`` net is held from one reference snapshot: its
forward within rtol 1e-5 / atol 1e-6, one update's parameters within
rtol 1e-4 / atol 1e-6 (float32 sums in another order).
"""

import os

import numpy as np
import pytest
import torch

from cxxnet_tpu.io import binpage as ref_binpage
from cxxnet_tpu.io import create_iterator as ref_create_iterator
from cxxnet_tpu.io import shard as ref_shard
from cxxnet_tpu_torch.io import binpage, create_iterator, shard
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.io.iter_batch import PrefetchIterator

N_IMG = 14          # ragged against batch 4
EPOCHS = 2
BATCH = 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ------------------------------------------------------------------ data

def write_jpegs(d, n=N_IMG, seed=3, lo=18, hi=28):
    """n seeded JPEGs of lo..hi px a side under d/imgs; returns their
    (index, labels (2), file name) rows."""
    import cv2
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(d, "imgs"), exist_ok=True)
    rows = []
    for i in range(n):
        h, w = rng.randint(lo, hi + 1, 2)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        fn = "im%03d.jpg" % i
        assert cv2.imwrite(os.path.join(d, "imgs", fn), img)
        rows.append((100 + i, (i % 3, (7 * i) % 5), fn))
    return rows


def write_list(path, rows, label_width=2):
    with open(path, "w") as f:
        for idx, labels, fn in rows:
            f.write("%d\t%s\t%s\n" % (idx, "\t".join(
                "%g" % v for v in labels[:label_width]), fn))


def write_bin(path, d, rows, bad_at=None):
    """A BinaryPage archive of the rows' JPEG bytes (written by the
    port); ``bad_at`` puts an undecodable object at that position."""
    w = binpage.PageWriter(path)
    for k, (_, _, fn) in enumerate(rows):
        if k == bad_at:
            w.write(b"not a jpeg at all")
        else:
            with open(os.path.join(d, "imgs", fn), "rb") as f:
                w.write(f.read())
    w.close()


def make_image_files(d, shards=3):
    """JPEGs, their lists ``img.lst`` (one label) and ``img2.lst`` (two),
    and ``shards`` BinaryPage shards
    ``part<i>.bin`` / ``part<i>.lst`` splitting the images (the last
    shard's second object undecodable, with a row of its own)."""
    d = str(d)
    rows = write_jpegs(d)
    write_list(os.path.join(d, "img.lst"), rows, 1)
    write_list(os.path.join(d, "img2.lst"), rows)
    bounds = np.linspace(0, len(rows), shards + 1).astype(int)
    for s in range(shards):
        part = rows[bounds[s]:bounds[s + 1]]
        bad = 1 if s == shards - 1 else None
        if bad is not None:
            part = part[:1] + [(900 + s, (0, 0), "missing.jpg")] + part[1:]
        write_list(os.path.join(d, "part%d.lst" % s), part)
        write_bin(os.path.join(d, "part%d.bin" % s), d, part, bad)
    return {"dir": d, "rows": rows}


def imgbin_block(f, kind="imgbin", *extra):
    return [("iter", kind), ("image_list", os.path.join(f["dir"],
                                                        "part0.lst")),
            ("image_bin", os.path.join(f["dir"], "part0.bin")),
            ("input_shape", "3,16,16"), ("silent", "1"),
            ("nthread", "2")] + list(extra)


def img_block(f, *extra):
    return [("iter", "img"), ("image_list",
                              os.path.join(f["dir"], "img.lst")),
            ("image_root", os.path.join(f["dir"], "imgs")),
            ("input_shape", "3,16,16"), ("silent", "1")] + list(extra)


def write_libsvm(path, n=23, nfeat=12, seed=4, base=0):
    """Seeded libsvm rows (two labels each), with a comment and blank
    lines."""
    rng = np.random.RandomState(seed)
    lines = ["# header comment", ""]
    for i in range(n):
        k = rng.randint(0, 5)
        idx = np.sort(rng.choice(nfeat, k, replace=False)) + base
        lines.append("%d,%d %s" % (rng.randint(3), rng.randint(2), " ".join(
            "%d:%g" % (j, round(float(rng.randn()), 4)) for j in idx))
            + ("  # row %d" % i if i % 5 == 0 else ""))
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def write_attach(path, ids, dim=3, seed=6):
    """attachtxt rows for ``ids`` (the others get zeros)."""
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        f.write("%d\n" % dim)
        for i in ids:
            f.write(" ".join([str(i)] + ["%.5f" % v for v in
                                         rng.randn(dim)]) + "\n")
    return path


def numpy_init(self, key, shape, in_num, out_num):
    """The reference's weight draw (``LayerParam.rand_init_weight``:
    gaussian, xavier or kaiming bounds) from a numpy stream seeded by
    the shape: XLA:CPU compiles ``jax.random``'s threefry program in
    about a second a shape, also when a trainer loads a snapshot (it
    initializes first). Tests patch it in where only the snapshot's
    values matter."""
    import jax.numpy as jnp
    rng = np.random.RandomState(int(np.prod(shape)) % (1 << 31))
    if self.random_type == 1:
        a = float(np.sqrt(3.0 / (in_num + out_num)))
        if self.init_uniform > 0:
            a = self.init_uniform
        w = rng.uniform(-a, a, shape)
    elif self.random_type == 0:
        w = self.init_sigma * rng.randn(*shape)
    else:
        n = self.num_hidden if self.num_hidden > 0 else \
            self.num_channel * self.kernel_width * self.kernel_height
        w = np.sqrt(2.0 / n) * rng.randn(*shape)
    return jnp.asarray(w.astype(np.float32))


# ------------------------------------------------------------- compare

def epochs(it, n=EPOCHS):
    """Every batch of n epochs, as private copies."""
    out = []
    for _ in range(n):
        for b in it:
            out.append((np.array(b.data), np.array(b.label),
                        None if b.inst_index is None
                        else np.array(b.inst_index), b.num_batch_padd,
                        [np.array(e) for e in b.extra_data]))
    return out


def run_both(block, global_cfg=(("batch_size", str(BATCH)),), n=EPOCHS):
    got = []
    for make in (ref_create_iterator, create_iterator):
        it = make(block, list(global_cfg))
        try:
            it.init()
            got.append(epochs(it, n))
        finally:
            it.close()
    return got


def assert_same_batches(ref, port):
    assert len(port) == len(ref) > 0
    for r, p in zip(ref, port):
        assert p[0].dtype == r[0].dtype and p[0].shape == r[0].shape
        for a, b in zip(r[:3], p[:3]):
            np.testing.assert_array_equal(b, a)
        assert p[3] == r[3]
        assert len(p[4]) == len(r[4])
        for a, b in zip(r[4], p[4]):
            np.testing.assert_array_equal(b, a)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("image_io")
    f = make_image_files(d)
    f["svm"] = write_libsvm(str(d / "rows.svm"))
    f["svm1"] = write_libsvm(str(d / "rows1.svm"), seed=5, base=1)
    return f


# ------------------------------------------------------------- binpage

def test_binpage_archives_byte_identical(tmp_path):
    """The same objects packed by either package's PageWriter give the
    same bytes, and each reader reads the other's archive."""
    rng = np.random.RandomState(0)
    objs = [rng.bytes(int(rng.randint(0, 3000))) for _ in range(50)]
    paths = {}
    for name, mod in (("ref", ref_binpage), ("port", binpage)):
        paths[name] = str(tmp_path / ("%s.bin" % name))
        w = mod.PageWriter(paths[name])
        for o in objs:
            w.write(o)
        w.close()
    with open(paths["ref"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()
    assert list(binpage.iter_objects(paths["ref"])) == objs
    assert list(ref_binpage.iter_objects(paths["port"])) == objs
    assert [len(p) for p in binpage.read_pages(paths["port"])] == [50]


def test_binpage_truncated_page_refused(tmp_path):
    path = str(tmp_path / "t.bin")
    w = binpage.PageWriter(path)
    w.write(b"abc")
    w.close()
    with open(path, "r+b") as f:
        f.truncate(binpage.KPAGE_BYTES - 100)
    for mod in (ref_binpage, binpage):
        with pytest.raises(IOError, match="truncated BinaryPage"):
            list(mod.iter_objects(path))


# -------------------------------------------------------------- imgbin

AUG = (("rand_crop", "1"), ("rand_mirror", "1"),
       ("mean_value", "123,117,104"))


def _conf(f, kind, *extra):
    return [("iter", kind),
            ("image_conf_prefix", os.path.join(f["dir"], "part%d")),
            ("input_shape", "3,16,16"), ("silent", "1"),
            ("nthread", "2")] + list(extra)


def _shards(f, kind, *extra):
    names = ["part%d" % s for s in range(3)]
    return [("iter", kind),
            ("image_list", " ".join(os.path.join(f["dir"], n + ".lst")
                                    for n in names)),
            ("image_bin", " ".join(os.path.join(f["dir"], n + ".bin")
                                   for n in names)),
            ("input_shape", "3,16,16"), ("silent", "1")] + list(extra)


IMGBIN_CASES = {
    # image_conf ids 0-2 in 2 parts: part 1 reads ids 1-2 (the bad
    # object among them is dropped)
    "imgbinx_conf_ids_part1": lambda f: _conf(
        f, "imgbinx", ("image_conf_ids", "0-2"), ("part_index", "1"),
        ("num_parts", "2"), *AUG),
    "imgbinold_conf_ids_label_width": lambda f: _conf(
        f, "imgbinold", ("image_conf_ids", "0-2"), ("label_width", "2"),
        ("round_batch", "0")) + [("iter", "threadbuffer")],
    # three explicit shards round-robin over 2 parts: part 0 reads 0, 2
    "imginst_shards_part0": lambda f: _shards(
        f, "imginst", ("part_index", "0"), ("num_parts", "2"), *AUG),
    "imgbin_shards_whole": lambda f: _shards(
        f, "imgbin", ("divideby", "255")) + [("iter", "membuffer")],
}


@pytest.mark.parametrize("case", sorted(IMGBIN_CASES))
def test_imgbin_chains_match_reference(files, case):
    ref, port = run_both(IMGBIN_CASES[case](files))
    assert_same_batches(ref, port)
    # the undecodable object never reaches a batch
    assert 900 + 2 not in set(np.concatenate([b[2] for b in port]))


def test_imgbin_more_objects_than_rows(files, tmp_path):
    lst = str(tmp_path / "short.lst")
    write_list(lst, files["rows"][:2])
    block = imgbin_block(files)
    block[1] = ("image_list", lst)
    for make in (ref_create_iterator, create_iterator):
        it = make(block, [("batch_size", "4")])
        with pytest.raises(IOError, match="more objects than rows"):
            it.init()
            list(it)
        it.close()


# ----------------------------------------------------------------- img

IMG_CASES = {
    # the order differs between the two epochs: seed_data advances
    "img_shuffle_seed": lambda f: img_block(
        f, ("shuffle", "1"), ("seed_data", "3"), *AUG),
    "img_parts_label_width": lambda f: img_block(
        f, ("image_list", os.path.join(f["dir"], "img2.lst")),
        ("part_index", "1"), ("num_parts", "2"), ("label_width", "2"),
        ("divideby", "255")) + [("iter", "threadbuffer")],
}


@pytest.mark.parametrize("case", sorted(IMG_CASES))
def test_img_chains_match_reference(files, case):
    ref, port = run_both(IMG_CASES[case](files))
    assert_same_batches(ref, port)
    if case == "img_shuffle_seed":
        per = len(port) // EPOCHS
        real = [b[2][:BATCH - b[3]] for b in port]
        first, second = np.concatenate(real[:per]), \
            np.concatenate(real[per:])
        assert sorted(first) == sorted(second)
        assert list(first) != list(second)


# -------------------------------------------------------------- libsvm

@pytest.mark.parametrize("key,base", [("svm", 0), ("svm1", 1)])
def test_libsvm_rows_and_csr_match_reference(files, key, base):
    """Dense batches (two labels, index_base) bit for bit, and the CSR
    store (``csr()``, ``sparse_inst``) array for array."""
    from cxxnet_tpu.io.iter_libsvm import LibSVMIterator as RefSVM
    from cxxnet_tpu_torch.io.iter_libsvm import LibSVMIterator
    block = [("iter", "libsvm"), ("filename", files[key]),
             ("input_shape", "1,1,12"), ("label_width", "2"),
             ("index_base", str(base)), ("silent", "1")]
    ref, port = run_both(block, [("batch_size", "5")])
    assert_same_batches(ref, port)
    its = []
    for cls in (RefSVM, LibSVMIterator):
        it = cls()
        for k, v in block[1:]:
            it.set_param(k, v)
        it.init()
        its.append(it)
    for a, b in zip(its[0].csr(), its[1].csr()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    for row in (0, 7, 22):
        r, p = its[0].sparse_inst(row), its[1].sparse_inst(row)
        np.testing.assert_array_equal(p.findex, r.findex)
        np.testing.assert_array_equal(p.dense(12), r.dense(12))


# ---------------------------------------------------- batch-block shard

@pytest.fixture(scope="module")
def shard_files(tmp_path_factory):
    from test_torch_port_io import write_raw_rec
    d = tmp_path_factory.mktemp("shard")
    rng = np.random.RandomState(8)
    csv = str(d / "rows.csv")
    with open(csv, "w") as f:
        for i in range(40):
            f.write(",".join([str(rng.randint(3))] + [
                "%.5f" % v for v in rng.rand(6)]) + "\n")
    return {"csv": csv, "rec": write_raw_rec(str(d / "r.rec"), 40, hw=20)}


def _shard_block(f, kind, *keys):
    if kind == "csv":
        base = [("iter", "csv"), ("filename", f["csv"]),
                ("input_shape", "1,1,6")]
    else:
        base = [("iter", "imgrec"), ("path_imgrec", f["rec"]),
                ("input_shape", "3,16,16"), ("decode_uint8", "1"),
                ("nthread", "2")]
    return base + [("silent", "1"), ("round_batch", "0")] + list(keys)


def _indices(block, make, local_batch, n=EPOCHS):
    """The real rows' inst_index of every batch of n epochs."""
    it = make(block, [("batch_size", str(local_batch))])
    out = []
    try:
        it.init()
        for _ in range(n):
            for b in it:
                out.append(np.array(
                    b.inst_index[:b.batch_size - b.num_batch_padd]))
    finally:
        it.close()
    return out


@pytest.mark.parametrize("kind", ["imgrec", "csv"])
def test_batch_shard_handoff_rederive(shard_files, kind):
    """A resumed pass (shard_start_record = 16, 2 global batches of 8
    consumed by a world of 4) re-derived for a world of 2: each new
    rank reads its slice from record 16 on in the first pass and the
    whole map after it; their slices per global batch concatenate to
    the unsharded order from 16 on, in both packages."""
    old = shard.ShardPlan(3, 4, 8)
    assert old.describe() == ref_shard.ShardPlan(3, 4, 8).describe()
    new = [old.rederive(r, 2, 2) for r in range(2)]
    assert [p.describe() for p in new] == [
        ref_shard.ShardPlan(3, 4, 8).rederive(r, 2, 2).describe()
        for r in range(2)]
    assert new[0].start_record == 16 and new[1].slice_of_batch(0) == (20, 24)
    got = {}
    for make in (ref_create_iterator, create_iterator):
        got[make] = [_indices(_shard_block(
            shard_files, kind, ("shard_kind", "batch"),
            ("shard_global_batch", "8"), ("shard_start_record", "16"),
            ("part_index", str(r)), ("num_parts", "2")), make, 4)
            for r in range(2)]
    assert all(np.array_equal(a, b) for ra, pa in zip(
        got[ref_create_iterator], got[create_iterator])
        for a, b in zip(ra, pa))
    ranks = got[create_iterator]
    # first pass: 24 records from 16 on (3 global batches), then the
    # steady pass over all 40
    first = np.concatenate([np.concatenate([ranks[0][k], ranks[1][k]])
                            for k in range(3)])
    np.testing.assert_array_equal(first, np.arange(16, 40))
    steady = np.concatenate([np.concatenate([ranks[0][k], ranks[1][k]])
                             for k in range(3, 8)])
    np.testing.assert_array_equal(steady, np.arange(40))


# ------------------------------------------------ attachtxt, extra data

EXTRA_NET = [
    ("input_shape", "1,1,6"), ("extra_data_num", "1"),
    ("extra_data_shape[0]", "1,1,3"), ("batch_size", "8"),
    ("netconfig", "start"),
    ("layer[in,in_1->h]", "concat"),
    ("layer[h->f1]", "fullc:f1"), ("nhidden", "16"),
    ("layer[f1->r]", "relu"),
    ("layer[r->o]", "fullc:fo"), ("nhidden", "3"),
    ("layer[o->o]", "softmax"),
    ("netconfig", "end"),
    ("eta", "0.3"), ("momentum", "0.9"), ("seed", "2"),
    ("metric", "error")]


def test_attachtxt_extra_data_net_matches_reference(shard_files, tmp_path,
                                                    monkeypatch):
    """attachtxt over a CSV chain (ids 0-24 in the file, the rest
    zeros) in both packages: the same extra_data; the two-input net
    from one reference snapshot: the same forward and one update."""
    from cxxnet_tpu.io.data import DataBatch as RefBatch
    from cxxnet_tpu.layers.base import LayerParam
    from cxxnet_tpu.nnet.trainer import NetTrainer as RefTrainer
    from cxxnet_tpu_torch.nnet.trainer import NetTrainer
    monkeypatch.setattr(LayerParam, "rand_init_weight", numpy_init)
    att = write_attach(str(tmp_path / "extra.txt"), range(25))
    block = _shard_block(shard_files, "csv") + [
        ("iter", "attachtxt"), ("filename", att)]
    ref, port = run_both(block, [("batch_size", "8")], n=1)
    assert_same_batches(ref, port)
    assert not port[-1][4][0][-8:].any()       # ids 32-39: no row
    rt = RefTrainer(EXTRA_NET)
    rt.init_model()
    snap = str(tmp_path / "s0.model.npz")
    rt.save_model(snap)
    pt = NetTrainer(EXTRA_NET, device="cpu")
    pt.load_model(snap)
    assert pt.net.node_shapes[pt.net.node_index_by_name("h")].flat_size \
        == 9
    data, label, idx, npad, extra = port[2]
    rb = RefBatch(data=data, label=label, inst_index=idx, extra_data=extra)
    pb = DataBatch(data=data, label=label, inst_index=idx, extra_data=extra)
    np.testing.assert_allclose(pt.extract_feature(pb, "o"),
                               rt.extract_feature(rb, "o"),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(pt.predict(pb), rt.predict(rb))
    zero = DataBatch(data=data, label=label, inst_index=idx,
                     extra_data=[np.zeros_like(extra[0])])
    assert np.abs(pt.extract_feature(zero, "o")
                  - pt.extract_feature(pb, "o")).max() > 1e-6
    rt.update(rb)
    pt.update(pb)
    np.testing.assert_allclose(pt.last_loss, float(rt._last_loss),
                               rtol=1e-5)
    ra, pa = rt.gather_snapshot()[0], pt.gather_snapshot()[0]
    for k in ra:
        if not k.startswith("__"):
            np.testing.assert_allclose(pa[k], ra[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)


# ------------------------------------------------- staging on the device

STAGE_NET = [
    ("input_shape", "3,16,16"), ("extra_data_num", "1"),
    ("extra_data_shape[0]", "1,1,3"), ("batch_size", "6"),
    ("netconfig", "start"),
    ("layer[in->f]", "flatten"),
    ("layer[f,in_1->h]", "concat"),
    ("layer[h->o]", "fullc:fo"), ("nhidden", "10"),
    ("layer[o->o]", "softmax"),
    ("netconfig", "end"),
    ("eta", "0.001"), ("momentum", "0.9"), ("seed", "2"),
    ("metric", "error")]

def test_staged_batches_equal_host_batches(shard_files, tmp_path):
    """A threadbuffer chain (imgrec, then attachtxt, then threadbuffer)
    with ``device_put_batch`` attached gives, on the CPU, the batches
    the same chain gives without it (data, labels, inst_index, padding,
    the extra input), as device-batch tensors with the labels' host
    copy; its ring buffers are handed back (reused) once each staged
    batch holds its own copy; an ``update_many`` window of staged
    batches trains as the host window does, bit for bit."""
    from cxxnet_tpu_torch.nnet.trainer import DeviceBatch, NetTrainer
    att = write_attach(str(tmp_path / "extra.txt"), range(0, 40, 3))
    block = _shard_block(shard_files, "imgrec") + [
        ("iter", "attachtxt"), ("filename", att),
        ("iter", "threadbuffer")]
    cfg = [("batch_size", "6")]
    host_it = create_iterator(block, cfg)
    host_it.init()
    host = epochs(host_it)
    host_it.close()
    t = NetTrainer(STAGE_NET, device="cpu")
    it = create_iterator(block, cfg)
    it.init()
    assert isinstance(it, PrefetchIterator)
    it.set_transform(t.device_put_batch)
    staged = []
    try:
        for _ in range(EPOCHS):
            for b in it:
                assert isinstance(b, DeviceBatch)
                assert isinstance(b.data, torch.Tensor) and b.ready is None
                staged.append((b.data.numpy().copy(), b.label.numpy().copy(),
                               np.array(b.inst_index), b.num_batch_padd,
                               [e.numpy().copy() for e in b.extra_data]))
                np.testing.assert_array_equal(b.host_label,
                                              b.label.numpy())
                assert (b.mask is None) == (b.num_batch_padd == 0)
        ring = it.base.base._ring.snapshot()
    finally:
        it.close()
    assert_same_batches(host, staged)
    assert t.staging == {"batches": len(host), "pinned": 0}
    assert ring["reused"] > 0 and not ring["pinned"]
    # an update_many window of two staged batches (one padded) against
    # the same window of host batches, from one seed: the same bits
    window = [DataBatch(data=d, label=lab, inst_index=i, num_batch_padd=n,
                        extra_data=e) for d, lab, i, n, e in host[5:7]]
    assert window[1].num_batch_padd > 0
    got = []
    for stage in (False, True):
        tr = NetTrainer(STAGE_NET, device="cpu")
        tr.init_model()
        tr.update_many([tr.device_put_batch(b) for b in window]
                       if stage else window)
        got.append((tr.gather_snapshot()[0], tr.train_metric_str()))
    assert got[1][1] == got[0][1] and "train-error" in got[0][1]
    for k, v in got[0][0].items():
        if not k.startswith("__"):
            np.testing.assert_array_equal(got[1][0][k], v, err_msg=k)


class _Event:
    """A stand-in for a CUDA event: the copy it follows completes only
    when it is synchronized, after a delay, as an in-flight DMA would."""

    def __init__(self, log, k, buf):
        self.log, self.k, self.buf = log, k, buf
        self.done = self.released = False

    def synchronize(self):
        import time
        time.sleep(0.002)
        self.done = True
        self.log.append(("copied", self.k))


def test_ring_buffer_released_only_after_its_copy(shard_files):
    """A fake staging transform whose copies complete only when their
    event is synchronized: every ring buffer is handed back after the
    copy that reads it, never before (the ring then refills it), also
    around a restart mid-epoch."""
    from cxxnet_tpu_torch.nnet.trainer import DeviceBatch
    block = _shard_block(shard_files, "csv") + [("iter", "threadbuffer")]
    it = create_iterator(block, [("batch_size", "4")])
    it.init()
    ring = it.base._ring
    log, events = [], []
    orig_release = ring.release

    def release(buf):
        ev = [e for e in events if e.buf is buf and not e.released][-1]
        ev.released = True
        log.append(("released", ev.k, ev.done))
        orig_release(buf)

    def stage(raw):
        # the batch's ring buffer, as BatchAdapter's release names it
        ev = _Event(log, len(events), raw.release.__defaults__[0])
        events.append(ev)
        return DeviceBatch(data=torch.from_numpy(raw.data.copy()),
                           label=torch.from_numpy(raw.label.copy()),
                           inst_index=np.array(raw.inst_index),
                           num_batch_padd=raw.num_batch_padd,
                           host_label=raw.label.copy(), ready=ev)

    ring.release = release
    it.set_transform(stage)
    try:
        n = sum(1 for _ in it)                 # a whole epoch
        it.before_first()                      # a restart mid-epoch
        assert it.next()
        m = sum(1 for _ in it)
    finally:
        it.close()
    assert n == m == 10
    released = [e for e in log if e[0] == "released"]
    assert len(released) >= 20
    assert all(done for _, _, done in released)
    for _, k, _ in released:
        assert log.index(("copied", k)) < log.index(("released", k, True))
    assert ring.reused > 0
