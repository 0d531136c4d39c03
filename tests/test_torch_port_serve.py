"""The port's serving slice as a whole against the JAX package.

Inception-BN-tiny with ``bn_fold_eval = 1``, ``bn_fuse_relu = 1`` and
``conv_pallas_epilogue = 1`` (the served Inception-BN configuration at
small widths). One module-scoped JAX trainer writes one snapshot with
realistic BN running stats; the port serves it on the CPU through
``ServeSession`` and must give the JAX trainer's answers.

Tolerance: softmax rows atol 1e-5 / rtol 1e-4 and identical argmax —
15 convolutions deep, f32 sums in another order in every contraction
(oneDNN here, XLA's lowerings there) and the reference's Pallas
epilogue in interpret mode vs the port's plain version.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cxxnet_tpu import models as jax_models
from cxxnet_tpu.graph import NetGraph as JaxNetGraph
from cxxnet_tpu.io.data import DataBatch as JaxBatch
from cxxnet_tpu.nnet.trainer import NetTrainer as JaxTrainer
from cxxnet_tpu.utils.config import parse_config as jax_parse
from cxxnet_tpu_torch.graph import NetGraph
from cxxnet_tpu_torch.io import DataBatch
from cxxnet_tpu_torch.models import inception_bn_tiny
from cxxnet_tpu_torch.nnet.checkpoint import SnapshotIntegrityError
from cxxnet_tpu_torch.nnet.trainer import NetTrainer
from cxxnet_tpu_torch.serve import ServeSession, run_closed_loop
from cxxnet_tpu_torch.utils.config import NotPortedError, parse_config

KNOBS = [("bn_fold_eval", "1"), ("bn_fuse_relu", "1"),
         ("conv_pallas_epilogue", "1")]
BATCH, IMAGE = 8, 32
ATOL, RTOL = 1e-5, 1e-4


def _cfg(extra=()):
    return parse_config(inception_bn_tiny(batch_size=BATCH,
                                          image_size=IMAGE)) \
        + KNOBS + list(extra)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The JAX trainer with realistic BN stats, its snapshot, inputs
    and answers. The reference's zero-initialized running stats fold to
    a ~1e5 scale; instead each BN gets the batch moments of its input on
    a calibration batch (one training-mode forward of the reference,
    whose running averages start from zero with momentum 0.9)."""
    d = tmp_path_factory.mktemp("port_serve")
    t = JaxTrainer(_cfg())
    t.init_model()
    rng = np.random.RandomState(0)

    def images():
        # per-image contrast and colour offset, so the globally pooled
        # features (and the predicted classes) differ between rows
        base = rng.randn(BATCH, IMAGE, IMAGE, 3).astype(np.float32)
        return base * rng.uniform(0.2, 3.0, (BATCH, 1, 1, 3)).astype(
            np.float32) + 2 * rng.randn(BATCH, 1, 1, 3).astype(np.float32)

    _, moved, _ = t.net.forward(t.params, t.net_state,
                                jnp.asarray(images()), is_train=True,
                                rng=jax.random.PRNGKey(0))
    t.net_state = {lk: {k: v / np.float32(0.1) for k, v in st.items()}
                   for lk, st in moved.items()}
    t.programs.residency = None
    path = str(d / "ref.model.npz")
    t.save_model(path)
    x = images()
    batch = JaxBatch(data=x, label=np.zeros((BATCH, 1), np.float32))
    probs = np.asarray(t.extract_feature(batch, "top"))
    pred = np.asarray(t.predict(batch))
    return {"dir": d, "path": path, "x": x, "probs": probs,
            "pred": pred, "trainer": t}


def test_reference_answers_are_usable(ref):
    """The comparison below means something: finite, normalized, and
    not one class for every row."""
    assert np.all(np.isfinite(ref["probs"]))
    np.testing.assert_allclose(ref["probs"].sum(1), 1.0, rtol=1e-5)
    assert len(set(ref["pred"].tolist())) > 1


def test_serve_session_matches_jax(ref):
    """Concurrent clients through the port's batcher on the CPU get the
    JAX trainer's rows, and the predict path agrees on the class."""
    sess = ServeSession(_cfg([("serve_buckets", "1,4,8")]),
                        model_path=ref["path"], device="cpu")
    try:
        x = ref["x"]
        futs = {}

        def client(lo, hi):
            futs[lo] = sess.submit(x[lo:hi])

        threads = [threading.Thread(target=client, args=(i, i + 2))
                   for i in range(0, BATCH, 2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
            assert not th.is_alive()
        got = np.concatenate([futs[i].result(timeout=60)
                              for i in sorted(futs)])
        np.testing.assert_allclose(got, ref["probs"], atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(sess.engine.predict(x), ref["pred"])
        stats = run_closed_loop(sess, x, clients=3, requests=3,
                                request_rows=3)
        assert stats["ok"] == 9 and stats["error"] == 0
    finally:
        summary = sess.close()
    # engine.predict dispatches directly; the batcher saw 4 + 9 requests
    assert summary["errors"] == 0 and summary["requests"] == 4 + 9


def test_trainer_predict_and_extract_match_jax(ref):
    t = NetTrainer(_cfg(), device="cpu")
    t.load_model(ref["path"])
    x = ref["x"]
    # a padded batch: the last rows are padding and are not returned
    batch = DataBatch(data=x, num_batch_padd=3)
    np.testing.assert_array_equal(t.predict(batch), ref["pred"][:5])
    np.testing.assert_allclose(t.extract_feature(DataBatch(x), "top"),
                               ref["probs"], atol=ATOL, rtol=RTOL)
    # an interior node in its natural NHWC shape: the first conv's
    # output carries the folded conv+BN+relu value, as in the reference
    jt = ref["trainer"]
    jb = JaxBatch(data=x, label=np.zeros((BATCH, 1), np.float32))
    np.testing.assert_allclose(t.extract_feature(DataBatch(x), "c1_c"),
                               np.asarray(jt.extract_feature(jb, "c1_c")),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("extra", [
    [("serve_weight_residency", "0")],          # fold per forward
    [("conv_pallas_epilogue", "0")],            # fold into the weight
], ids=["residency_off", "weight_fold"])
def test_fold_variants_match_jax(ref, extra):
    t = NetTrainer(_cfg(extra), device="cpu")
    t.load_model(ref["path"])
    got = t.extract_feature(DataBatch(ref["x"]), "top")
    np.testing.assert_allclose(got, ref["probs"], atol=ATOL, rtol=RTOL)


def test_snapshots_cross_both_ways(ref):
    """JAX snapshot -> port load -> port save -> JAX load: the weights
    arrive bit-identical and each package verifies the other's digest."""
    jt = ref["trainer"]
    port = NetTrainer(_cfg(), device="cpu")
    port.load_model(ref["path"])
    out = str(ref["dir"] / "port.model.npz")
    port.save_model(out)
    back = JaxTrainer(_cfg())
    back.load_model(out)
    ja, _ = jt.gather_snapshot()
    ba, _ = back.gather_snapshot()
    pa, _ = port.gather_snapshot()
    assert set(ja) == set(ba) == set(pa)
    for k in ja:
        np.testing.assert_array_equal(ba[k], ja[k])
        np.testing.assert_array_equal(pa[k], ja[k])
    jb = JaxBatch(data=ref["x"], label=np.zeros((BATCH, 1), np.float32))
    np.testing.assert_array_equal(np.asarray(back.predict(jb)),
                                  ref["pred"])
    # a port-written snapshot with a flipped byte fails its digest in
    # the port too
    raw = bytearray(open(out, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    bad = str(ref["dir"] / "bad.model.npz")
    with open(bad, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(SnapshotIntegrityError):
        NetTrainer(_cfg(), device="cpu").load_model(bad)


def test_params_from_numpy_carries_jax_weights(ref):
    """The JAX trainer's gathered arrays, handed straight to
    ``params_from_numpy`` (no snapshot file), drive the port's net to
    the reference's answers."""
    from cxxnet_tpu_torch.nnet.convert import params_from_numpy
    arrays, _ = ref["trainer"].gather_snapshot()
    params, state = params_from_numpy(arrays, "cpu")
    t = NetTrainer(_cfg(), device="cpu")
    t.init_model()
    assert {lk: set(s) for lk, s in params.items()} == \
        {lk: set(s) for lk, s in t.params.items()}
    t._install(params, state)
    got = t.extract_feature(DataBatch(ref["x"]), "top")
    np.testing.assert_allclose(got, ref["probs"], atol=ATOL, rtol=RTOL)


def test_reference_layout_weights_match_jax(ref):
    jt = ref["trainer"]
    port = NetTrainer(_cfg(), device="cpu")
    port.load_model(ref["path"])
    for lk, tag in (("conv1_conv", "wmat"), ("fc1", "wmat"),
                    ("fc1", "bias"), ("conv1_bn", "wmat")):
        np.testing.assert_array_equal(port.get_weight(lk, tag),
                                      jt.get_weight(lk, tag))
    w = port.get_weight("fc1", "wmat")
    port.set_weight("fc1", "wmat", w * 2)
    np.testing.assert_array_equal(port.get_weight("fc1", "wmat"), w * 2)
    assert port.params["fc1"]["wmat"].shape == \
        tuple(jt.params["fc1"]["wmat"].shape)


def _zoo():
    m = jax_models
    return {
        "mnist_mlp": m.mnist_mlp(), "mnist_conv": m.mnist_conv(),
        "alexnet": m.alexnet(), "kaggle_bowl": m.kaggle_bowl(),
        "kaiming": m.kaiming(), "kaiming_fused": m.kaiming(
            fused_pools=True),
        "inception_bn": m.inception_bn(),
        "inception_bn_tiny": m.inception_bn_tiny(),
    }


@pytest.mark.parametrize("name", sorted(_zoo()))
def test_zoo_graph_to_dict_matches_jax(name):
    text = _zoo()[name]
    pairs = parse_config(text)
    assert [tuple(p) for p in jax_parse(text)] == pairs
    jg, pg = JaxNetGraph(), NetGraph()
    jg.configure(jax_parse(text))
    pg.configure(pairs)
    assert pg.to_dict() == jg.to_dict()
    assert NetGraph.from_dict(jg.to_dict()).to_dict() == jg.to_dict()


def test_port_model_builders_match_jax():
    assert inception_bn_tiny() == jax_models.inception_bn_tiny()
    from cxxnet_tpu_torch.models import inception_bn
    assert inception_bn() == jax_models.inception_bn()


@pytest.mark.parametrize("extra,item", [
    ([("serve_dtype", "fp8")], "quantized"),
    ([("serve_dtype", "float8_e4m3")], "quantized"),
    ([("serve_device_mem_budget", "512")], "quantized"),
    ([("remat", "full")], "rematerialization"),
    ([("channel_pad", "128")], "CLI remainder"),
    ([("shard_optimizer", "1")], "multi-GPU"),
    ([("update_on_server", "1")], "multi-GPU"),
    ([("remat", "conv")], "rematerialization"),
    ([("grad_sync", "overlap")], "multi-GPU"),
    ([("input_layout", "rowmajor")], "CLI remainder"),
], ids=["fp8", "fp8_alias", "serve_device_mem_budget", "remat_full",
        "channel_pad", "shard_optimizer", "update_on_server", "remat",
        "grad_sync", "input_layout"])
def test_unported_keys_raise(ref, extra, item):
    with pytest.raises(NotPortedError, match=item):
        t = NetTrainer(_cfg(extra), device="cpu")
        t.load_model(ref["path"])


def test_pool_concat_pallas_builds_and_fuses_on_the_tower():
    """``pool_concat_pallas = 1`` is ported: the key builds, and on
    chip_smoke.py's full-width Inception tower (shapes only) two concats
    fuse, t3a's avg and t4a's max pool passing their inputs through
    (no forward)."""
    import chip_smoke
    t = NetTrainer(parse_config(chip_smoke.tower_text(4))
                   + [("pool_concat_pallas", "1")], device="cpu")
    t.init_model()
    net = t.net
    assert sorted(m for _, _, m in net.fused_concats.values()) == \
        ["avg", "max"]
    assert all(pos == 3 and k == 3 for pos, k, _ in
               net.fused_concats.values())
    assert len(net._pool_passthrough) == 2


@pytest.fixture(scope="module")
def ref_bf16(ref):
    """The reference's eval rows of the snapshot at ``dtype =
    bfloat16``: convolutions and fullc on bf16 operands, activations
    bf16 between layers."""
    t = JaxTrainer(_cfg([("dtype", "bfloat16")]))
    t.load_model(ref["path"])
    batch = JaxBatch(data=ref["x"], label=np.zeros((BATCH, 1), np.float32))
    return np.asarray(t.extract_feature(batch, "top"))


@pytest.mark.parametrize("extra", [
    [("dtype", "bfloat16")],
    [("momentum_dtype", "bfloat16")],
    [("dtype", "bfloat16"), ("grad_dtype", "bfloat16"),
     ("momentum_dtype", "bfloat16")],
], ids=["bf16_compute", "momentum_dtype", "bench_set"])
def test_low_precision_training_keys_load_train_and_serve(ref, ref_bf16,
                                                          extra):
    """The reference's mixed-precision keys (no longer refused) load
    the snapshot, predict as the reference does at that dtype, and take
    a training step: masters stay float32, the momentum is stored in the
    configured dtype. Rows: float32 within the module's tolerance; bf16
    within atol 4e-3 (15 bf16 convolutions deep, each output rounded to
    8 bits, and oneDNN and XLA round a bf16 sum differently now and
    then), with the same argmax. tests/test_torch_port_bf16.py holds
    the training steps to the reference's."""
    t = NetTrainer(_cfg(extra), device="cpu")
    t.load_model(ref["path"])
    bf16 = ("dtype", "bfloat16") in extra
    got = t.extract_feature(DataBatch(ref["x"]), "top")
    want = ref_bf16 if bf16 else ref["probs"]
    np.testing.assert_allclose(got, want, rtol=0 if bf16 else RTOL,
                               atol=4e-3 if bf16 else ATOL)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    rng = np.random.RandomState(3)
    t.update(DataBatch(ref["x"], rng.randint(0, want.shape[1], (BATCH, 1))
                       .astype(np.float32)))
    assert np.isfinite(t.last_loss)
    want_m = torch.bfloat16 if ("momentum_dtype", "bfloat16") in extra \
        else torch.float32
    for lk, tags in t.opt_state.items():
        for tag, st in tags.items():
            assert t.params[lk][tag].dtype == torch.float32
            assert not st or st["m_w"].dtype == want_m


def test_grad_dtype_without_bf16_compute_raises(ref):
    """``grad_dtype = bfloat16`` needs ``dtype = bfloat16``: the
    reference's ValueError."""
    t = NetTrainer(_cfg([("grad_dtype", "bfloat16")]), device="cpu")
    with pytest.raises(ValueError, match="requires dtype=bfloat16"):
        t.load_model(ref["path"])


def test_unported_layer_type_and_bundle_raise(ref, tmp_path):
    """No layer type of the reference is unported any more (``lrn``,
    once the example, builds); an unported net key and a sealed bundle
    still raise NotPortedError."""
    text = ("netconfig=start\nlayer[0->1] = lrn\n"
            "netconfig=end\ninput_shape = 3,8,8\nbatch_size = 2\n")
    NetTrainer(parse_config(text), device="cpu").init_model()
    with pytest.raises(NotPortedError, match="channel_pad"):
        NetTrainer(parse_config(text + "channel_pad = 1\n"),
                   device="cpu").init_model()
    bundle = tmp_path / "0001.model.bundle"
    os.makedirs(bundle)
    with pytest.raises(NotPortedError, match="sealed bundles"):
        ServeSession(_cfg(), model_path=str(bundle), device="cpu")


def test_port_init_is_seeded():
    a = NetTrainer(_cfg([("seed", "3")]), device="cpu")
    b = NetTrainer(_cfg([("seed", "3")]), device="cpu")
    a.init_model()
    b.init_model()
    for lk, sub in a.params.items():
        for tag, v in sub.items():
            assert torch.equal(v, b.params[lk][tag])
