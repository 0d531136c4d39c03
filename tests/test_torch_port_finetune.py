"""``task = finetune`` in the port against the reference's
``tests/test_finetune.py``, case for case (the bundle case through the
port's own export: the reference's bundle boot fails in this container),
and ``finetune_from`` on
a reference snapshot: the same layers carried, bit for bit, and the same
first update within ``UPDATE_RTOL`` / ``UPDATE_ATOL`` (the reference's
step compiled for one device; XLA:CPU and PyTorch's CPU products sum in
different orders).
"""

import os

import numpy as np
import pytest
import torch

from cxxnet_tpu import parallel as ref_parallel
from cxxnet_tpu.io.data import DataBatch as RefBatch
from cxxnet_tpu.nnet.trainer import NetTrainer as RefTrainer
from cxxnet_tpu.utils.config import parse_config as ref_parse_config
from cxxnet_tpu_torch.io.data import DataBatch
from cxxnet_tpu_torch.main import main
from cxxnet_tpu_torch.nnet.checkpoint import read_snapshot
from cxxnet_tpu_torch.nnet.trainer import FinetuneShapeError, NetTrainer
from cxxnet_tpu_torch.updater.param import UpdaterParam
from cxxnet_tpu_torch.utils.config import parse_config
from tests.test_main import write_conf
from tests.test_trainer import MLP_CONF, synth_idx

UPDATE_RTOL, UPDATE_ATOL = 1e-5, 1e-7


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A trained 4-class source model and a 6-class finetune conf whose
    head (fc2) is remapped and whose backbone (fc1) carries a group
    multiplier."""
    tmp_path = tmp_path_factory.mktemp("ft")
    pimg, plab = synth_idx(str(tmp_path), n=300, name="tr")
    pimg2, plab2 = synth_idx(str(tmp_path), n=100, seed=5, name="te")
    conf = write_conf(tmp_path, pimg, plab, pimg2, plab2,
                      extra="dev = cpu\n")
    assert main([conf, "num_round=1"]) == 0
    model = str(tmp_path / "models" / "0001.model.npz")
    conf6 = (tmp_path / "run.conf").read_text() \
        .replace("layer[h->o] = fullc:fc2\n  nhidden = 4",
                 "layer[h->o] = fullc:fc2\n  nhidden = 6\n"
                 "  lr_mult = 4") \
        .replace("layer[+1:h] = fullc:fc1\n  nhidden = 32",
                 "layer[+1:h] = fullc:fc1\n  nhidden = 32\n"
                 "  wmult = 0.1\n  bmult = 0.1")
    p6 = str(tmp_path / "run6.conf")
    with open(p6, "w") as f:
        f.write(conf6)
    return tmp_path, conf, p6, model


def test_finetune_remap_end_to_end(setup):
    """The acceptance path from the plain snapshot: remap the head to 6
    classes and train with per-group LR scaling; the remapped head is
    freshly sized and the carried backbone leaves the source bit for
    bit at the bootstrap."""
    tmp_path, conf, p6, model = setup
    mdir = str(tmp_path / "ft")
    boot = {}
    orig = NetTrainer.finetune_from

    def spy(self, path, remap=(), strict=True):
        rec = orig(self, path, remap, strict)
        boot.update(rec=rec, fc1=self.params["fc1"]["wmat"].clone())
        return rec

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(NetTrainer, "finetune_from", spy)
        assert main([p6, "task=finetune", "model_in=" + model,
                     "finetune_remap=fc2", "num_round=1",
                     "model_dir=" + mdir]) == 0
    rec = boot["rec"]
    assert rec["carried_layers"] == ["fc1"]
    assert rec["remapped_layers"] == ["fc2"]
    _, src_meta = read_snapshot(model)
    assert rec["source_digest"] == src_meta["content_digest"]
    src, _ = read_snapshot(model)
    np.testing.assert_array_equal(boot["fc1"].numpy(),
                                  src["param/fc1/wmat"])
    snap, _ = read_snapshot(os.path.join(mdir, "0001.model.npz"))
    assert snap["param/fc2/wmat"].shape == (32, 6)
    assert snap["param/fc2/bias"].shape == (6,)


def test_finetune_bundle_remap_end_to_end(setup):
    """The reference's acceptance path from a sealed bundle: export the
    source, finetune from the bundle with the head remapped (the carry
    record names the bundle and the inner snapshot's digest; the carried
    backbone is the source's bits), export the finetuned model, and
    boot the new bundle from its manifest alone (every program a hit:
    none on the CPU)."""
    from cxxnet_tpu.artifact.bundle import verify_bundle as ref_verify
    from cxxnet_tpu_torch.artifact.bundle import serve_cfg_from_bundle
    from cxxnet_tpu_torch.monitor import MemorySink, Monitor
    from cxxnet_tpu_torch.monitor.schema import read_jsonl, validate_records
    from cxxnet_tpu_torch.serve import ServeSession
    tmp_path, conf, p6, model = setup
    assert main([conf, "task=export", "model_in=" + model]) == 0
    bundle = model[:-len(".npz")] + ".bundle"
    assert ref_verify(bundle)["ok"]
    mdir = str(tmp_path / "ft_bundle")
    mon_file = str(tmp_path / "ft_bundle.jsonl")
    assert main([p6, "task=finetune", "model_in=" + bundle,
                 "finetune_remap=fc2", "num_round=1", "model_dir=" + mdir,
                 "monitor=jsonl", "monitor_path=" + mon_file]) == 0
    records = read_jsonl(mon_file)
    assert validate_records(records, strict=False) == []
    (rec,) = [r for r in records if r["event"] == "finetune"]
    assert rec["source"] == bundle
    assert rec["carried_layers"] == ["fc1"]
    assert rec["remapped_layers"] == ["fc2"]
    _, src_meta = read_snapshot(model)
    assert rec["source_digest"] == src_meta["content_digest"]
    snap, _ = read_snapshot(os.path.join(mdir, "0001.model.npz"))
    assert snap["param/fc2/wmat"].shape == (32, 6)
    ft_model = os.path.join(mdir, "0001.model.npz")
    assert main([p6, "task=export", "model_in=" + ft_model]) == 0
    ft_bundle = os.path.join(mdir, "0001.model.bundle")
    sink = MemorySink()
    session = ServeSession(serve_cfg_from_bundle(ft_bundle),
                           model_path=ft_bundle, monitor=Monitor(sink),
                           device="cpu")
    try:
        out = session.predict(np.zeros((2, 256), np.float32))
    finally:
        session.close()
    assert out.shape == (2, 6)
    (art,) = [r for r in sink.records if r["event"] == "artifact_load"]
    assert art["fingerprint_match"] and art["rebuilds"] == 0


def test_shape_mismatch_without_remap_is_typed_and_names_layer(setup):
    tmp_path, conf, p6, model = setup
    with pytest.raises(FinetuneShapeError) as ei:
        main([p6, "task=finetune", "model_in=" + model,
              "num_round=1", "model_dir=" + str(tmp_path / "e")])
    assert ei.value.layer == "fc2"
    assert "fc2" in str(ei.value)
    assert "finetune_remap" in str(ei.value)
    assert main([p6, "task=finetune", "model_in=" + model,
                 "finetune_strict=0", "num_round=1",
                 "model_dir=" + str(tmp_path / "ns")]) == 0
    snap, _ = read_snapshot(str(tmp_path / "ns" / "0001.model.npz"))
    assert snap["param/fc2/wmat"].shape == (32, 6)


def test_unknown_remap_layer_is_an_error(setup):
    tmp_path, conf, p6, model = setup
    with pytest.raises(ValueError, match="ghost"):
        main([p6, "task=finetune", "model_in=" + model,
              "finetune_remap=ghost", "num_round=1",
              "model_dir=" + str(tmp_path / "g")])


def test_frozen_group_is_bit_identical_after_updates(setup):
    tmp_path, conf, p6, model = setup
    frozen = (tmp_path / "run6.conf").read_text() \
        .replace("  wmult = 0.1\n  bmult = 0.1", "  lr_mult = 0")
    pf = str(tmp_path / "frozen.conf")
    with open(pf, "w") as f:
        f.write(frozen)
    mdir = str(tmp_path / "fr")
    assert main([pf, "task=finetune", "model_in=" + model,
                 "finetune_remap=fc2", "num_round=2",
                 "model_dir=" + mdir]) == 0
    src, _ = read_snapshot(model)
    out, _ = read_snapshot(os.path.join(mdir, "0002.model.npz"))
    np.testing.assert_array_equal(src["param/fc1/wmat"],
                                  out["param/fc1/wmat"])
    np.testing.assert_array_equal(src["param/fc1/bias"],
                                  out["param/fc1/bias"])
    assert out["param/fc2/wmat"].shape == (32, 6)
    assert float(np.abs(out["param/fc2/wmat"]).sum()) > 0


def test_resume_preserves_remap(setup):
    """continue = 1 on a finetune run resumes the run's own snapshot:
    with every group frozen, 0002 equals 0001 bit for bit (a re-remap
    would have re-initialized fc2)."""
    tmp_path, conf, p6, model = setup
    frozen = (tmp_path / "run6.conf").read_text() \
        .replace("  wmult = 0.1\n  bmult = 0.1", "  lr_mult = 0") \
        .replace("  lr_mult = 4", "  lr_mult = 0")
    pf = str(tmp_path / "frozen_all.conf")
    with open(pf, "w") as f:
        f.write(frozen)
    mdir = str(tmp_path / "rs")
    assert main([pf, "task=finetune", "model_in=" + model,
                 "finetune_remap=fc2", "num_round=1",
                 "model_dir=" + mdir]) == 0
    assert main([pf, "task=finetune", "model_in=" + model,
                 "finetune_remap=fc2", "continue=1", "num_round=2",
                 "model_dir=" + mdir]) == 0
    a, _ = read_snapshot(os.path.join(mdir, "0001.model.npz"))
    b, _ = read_snapshot(os.path.join(mdir, "0002.model.npz"))
    assert b["param/fc2/wmat"].shape == (32, 6)
    for k in ("param/fc1/wmat", "param/fc1/bias",
              "param/fc2/wmat", "param/fc2/bias"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_lr_mult_and_aliases_scope_to_groups():
    p = UpdaterParam(tag="wmat")
    p.set_param("lr", "0.5")
    p.set_param("lr_mult", "0.1")
    p.schedule_epoch(0)
    assert p.learning_rate == pytest.approx(0.05)

    p = UpdaterParam(tag="wmat")
    p.set_param("lr", "0.5")
    p.set_param("wmult", "2")
    p.set_param("bmult", "7")            # wrong tag: ignored
    p.schedule_epoch(0)
    assert p.learning_rate == pytest.approx(1.0)

    p = UpdaterParam(tag="bias")
    p.set_param("lr", "0.5")
    p.set_param("wmult", "2")            # wrong tag: ignored
    p.set_param("bmult", "3")
    p.schedule_epoch(0)
    assert p.learning_rate == pytest.approx(1.5)

    p = UpdaterParam(tag="bias")
    p.set_param("lr", "0.5")
    p.set_param("wmat:lr_mult", "9")     # other tag's scoped key
    p.set_param("bias:lr_mult", "0")
    p.schedule_epoch(0)
    assert p.learning_rate == 0.0        # exact zero, not lr_minimum


def test_trainer_finetune_from_plain_snapshot_matches_copy(tmp_path):
    src = NetTrainer(parse_config(MLP_CONF), device="cpu")
    src.init_model()
    path = str(tmp_path / "src.npz")
    src.save_model(path)
    a = NetTrainer(parse_config(MLP_CONF), device="cpu")
    a.init_model()
    rec = a.finetune_from(path)
    assert sorted(rec["carried_layers"]) == ["fc1", "fc2"]
    assert rec["remapped_layers"] == [] and rec["frozen_groups"] == []
    b = NetTrainer(parse_config(MLP_CONF), device="cpu")
    b.init_model()
    b.copy_model_from(path)
    for lk in ("fc1", "fc2"):
        for tag in ("wmat", "bias"):
            assert torch.equal(a.params[lk][tag], b.params[lk][tag])


def test_load_weights_inplace_refreshes_and_refuses_shape_change(tmp_path):
    src = NetTrainer(parse_config(MLP_CONF), device="cpu")
    src.init_model()
    src.update_counter = 7
    path = str(tmp_path / "src.npz")
    src.save_model(path)
    t = NetTrainer(parse_config(MLP_CONF) + [("seed", "3")], device="cpu")
    t.init_model()
    t.load_weights_inplace(path)
    assert t.update_counter == 7
    assert torch.equal(t.params["fc1"]["wmat"], src.params["fc1"]["wmat"])
    wide = NetTrainer(parse_config(MLP_CONF.replace("nhidden = 4",
                                                    "nhidden = 6")),
                      device="cpu")
    wide.init_model()
    with pytest.raises(ValueError, match="fc2"):
        wide.load_weights_inplace(path)


def test_finetune_from_reference_snapshot(tmp_path, monkeypatch):
    """finetune_from on a reference snapshot, remapping a 6-class head:
    the port carries the reference's layers bit for bit and takes the
    same first update as the reference's own finetune_from."""
    monkeypatch.setattr(ref_parallel, "default_data_axis",
                        lambda *a, **k: 1)
    ref_src = RefTrainer(ref_parse_config(MLP_CONF))
    ref_src.init_model()
    path = str(tmp_path / "ref.model.npz")
    ref_src.save_model(path)
    conf6 = MLP_CONF.replace("nhidden = 4", "nhidden = 6")
    ref = RefTrainer(ref_parse_config(conf6))
    ref.init_model()
    ref_rec = ref.finetune_from(path, remap=("fc2",))
    port = NetTrainer(parse_config(conf6), device="cpu")
    port.init_model()
    rec = port.finetune_from(path, remap=("fc2",))
    assert rec["carried_layers"] == ref_rec["carried_layers"] == ["fc1"]
    assert rec["remapped_layers"] == ref_rec["remapped_layers"] == ["fc2"]
    assert rec["source_digest"] == ref_rec["source_digest"]
    for tag in ("wmat", "bias"):
        np.testing.assert_array_equal(port.params["fc1"][tag].numpy(),
                                      np.asarray(ref.params["fc1"][tag]))
    # the same fresh head in both, then one update on one batch
    for tag in ("wmat", "bias"):
        port.params["fc2"][tag] = torch.from_numpy(
            np.array(ref.params["fc2"][tag]))
    rng = np.random.RandomState(0)
    data = rng.rand(50, 256).astype(np.float32)
    label = rng.randint(0, 6, (50, 1)).astype(np.float32)
    ref.update(RefBatch(data=data, label=label))
    port.update(DataBatch(data=data, label=label))
    for lk in ("fc1", "fc2"):
        for tag in ("wmat", "bias"):
            np.testing.assert_allclose(
                port.params[lk][tag].numpy(),
                np.asarray(ref.params[lk][tag]), rtol=UPDATE_RTOL,
                atol=UPDATE_ATOL, err_msg=lk + tag)
