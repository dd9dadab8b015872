"""The port's Spark-ML pipeline (``pipeline.py``: ``TFEstimator`` /
``TFModel``) held against the JAX package's.

Mirrors ``tests/test_pipeline.py``: a seeded linear-regression table
(``y = x . (3.14, 1.618) + 0.5``) trained through the estimator in FEED
mode (two ranks, data-parallel over gloo) and FILES mode (TFRecords, an
``export_fn``), then transformed back through the model from a checkpoint
or an export. The transform's rows align 1:1 with the input, equal the
port's in-process ``predict`` on the same batches, and equal JAX
``LoadedModel.predict`` on the same weights to 1e-5. Every ``Has*`` mixin
of the JAX package exists with the same default. Node programs live in
``tests/torch_ml_programs.py`` (jax-free; executors spawn and import it).
"""

import os

import numpy as np
import pytest
import torch

import torch_ml_programs as progs
from tensorflowonspark_tpu import export as jax_export
from tensorflowonspark_tpu import pipeline as jax_pipeline
from tensorflowonspark_tpu_torch import backend as backend_mod
from tensorflowonspark_tpu_torch import export, pipeline
from tensorflowonspark_tpu_torch.cluster import InputMode
from tensorflowonspark_tpu_torch.data import dfutil
from tensorflowonspark_tpu_torch.models import factory
from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager

pytestmark = pytest.mark.watchdog_timeout(120)
TRUE_W = (3.14, 1.618)
BIAS = 0.5
TOL = 1e-5
HAS = sorted(n for n in dir(jax_pipeline) if n.startswith("Has"))


def _make_table(n=128, seed=13):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 2).astype(np.float32)
    y = (x @ np.asarray(TRUE_W) + BIAS).astype(np.float32)
    rows = [{"x": x[i].tolist(), "y": float(y[i])} for i in range(n)]
    return dfutil.Table(
        rows, schema={"x": dfutil.ARRAY_FLOAT, "y": dfutil.FLOAT}
    )


def _x(table):
    return np.asarray([row["x"] for row in table], np.float32)


def _jax_predict(tmp_path, variables, x):
    """JAX ``LoadedModel.predict`` on the port's linear-regression weights."""
    params = {"Dense_0": {"kernel": variables["Dense_0.kernel"].numpy(),
                          "bias": variables["Dense_0.bias"].numpy()}}
    d = str(tmp_path / "jax_export")
    jax_export.export_saved_model(d, "linear_regression", params=params)
    return np.asarray(jax_export.load_saved_model(d).predict(x)["out"])


def _in_process(loaded, x, parts, batch_size):
    """The port's ``predict`` on the transform's own batches: the rows of
    each round-robin partition, in chunks of ``batch_size``."""
    out = np.zeros((len(x), 1), np.float32)
    for p in range(parts):
        idx = np.arange(p, len(x), parts)
        for s in range(0, len(idx), batch_size):
            chunk = idx[s:s + batch_size]
            out[chunk] = loaded.predict(x[chunk])["out"]
    return out


def _check(tmp_path, table, out, loaded, col, parts, batch_size):
    assert len(out) == len(table)
    got = np.asarray([row[col] for row in out], np.float32).reshape(-1, 1)
    x = _x(table)
    np.testing.assert_array_equal(
        got, _in_process(loaded, x, parts, batch_size))
    np.testing.assert_allclose(got, _jax_predict(tmp_path, loaded.variables,
                                                 x), atol=TOL, rtol=TOL)
    # Trained: closer to the known line than the seed's weights.
    want = (x @ np.asarray(TRUE_W, np.float32) + BIAS)[:, None]
    init = factory.get_model("linear_regression", device="cpu")
    with torch.no_grad():
        before = init(torch.as_tensor(x)).numpy()
    assert np.abs(got - want).mean() < 0.5 * np.abs(before - want).mean()


@pytest.mark.parametrize("name", HAS)
def test_has_mixin_defaults_equal_jax(name):
    jax_mixin, port_mixin = getattr(jax_pipeline, name), getattr(pipeline,
                                                                 name)
    assert port_mixin._param_defaults == jax_mixin._param_defaults
    for attr in vars(jax_mixin):
        if attr.startswith(("set", "get")):
            assert callable(getattr(port_mixin, attr)), attr
    assert issubclass(pipeline.TFParams, port_mixin)


def test_device_param_defaults_to_the_card():
    assert pipeline.TFModel().getDevice() == "cuda"
    assert pipeline.HasDevice._param_defaults == {"device": "cuda"}
    assert pipeline.TFModel().setDevice("cpu").getDevice() == "cpu"


def test_namespace_and_params():
    ns = pipeline.Namespace({"a": 1})
    merged = ns.merge({"b": 2})
    assert merged.a == 1 and merged.b == 2 and "a" in merged
    assert pipeline.Namespace(merged) == merged
    with pytest.raises(TypeError, match="argv lists"):
        pipeline.Namespace(["--a", "1"])

    def configure(est):
        return est.setBatchSize(17).setEpochs(3).setNumPS(1) \
            .setDriverPSNodes(False).setInputMapping({"x": "x"})

    est = configure(pipeline.TFEstimator(progs.linreg_feed, {"lr": 0.5}))
    jest = configure(jax_pipeline.TFEstimator(None, {"lr": 0.5}))
    args = est.merge_args_params({"lr": 0.5, "batch_size": 3})
    jargs = jest.merge_args_params({"lr": 0.5, "batch_size": 3})
    assert args.batch_size == 17 and args.epochs == 3 and args.lr == 0.5
    assert est.getBatchSize() == 17 and est.getNumPS() == 1
    # The JAX package's merge, plus the port's device.
    assert {k: v for k, v in vars(args).items() if k != "device"} == \
        vars(jargs) and args.device == "cuda"
    argv = est.merge_args_params(["--lr", "0.5"])
    jargv = jest.merge_args_params(["--lr", "0.5"])
    assert argv[:2] == ["--lr", "0.5"] and "--batch_size" in argv
    i = argv.index("--device")
    assert argv[:i] + argv[i + 2:] == jargv and argv[i + 1] == "cuda"
    table = _make_table(4)
    assert est._input_columns(table) == ["x"]
    est.setInputMapping(None)
    assert est._input_columns(table) == ["x", "y"]
    assert est._feed_rows(table)[0] == [table[0]["x"], table[0]["y"]]


def test_transform_requires_model():
    with pytest.raises(ValueError, match="export_dir or model_dir"):
        pipeline.TFModel().transform(_make_table(4))


def test_yield_batch_keeps_the_short_tail():
    assert list(pipeline.yield_batch(iter(range(7)), 3)) == [
        [0, 1, 2], [3, 4, 5], [6]]


@pytest.mark.parametrize("use_export", [False, True],
                         ids=["checkpoint", "export"])
def test_estimator_feed_fit_transform(tmp_path, use_export):
    """FEED-mode fit over two ranks, then transform through the checkpoint
    or through the export each rank's ``ctx.export_saved_model`` reached
    (rank 0 wrote it)."""
    table = _make_table()
    model_dir = str(tmp_path / "model")
    export_dir = str(tmp_path / "export")
    est = (
        pipeline.TFEstimator(progs.linreg_feed, {"use_export_fn": False})
        .setInputMapping({"x": "x", "y": "y"})
        .setClusterSize(2)
        .setEpochs(6)
        .setBatchSize(16)
        .setModelDir(model_dir)
        .setTimeout(100)
        .setDevice("cpu")
    )
    if use_export:
        est.setExportDir(export_dir)
    with backend_mod.LocalBackend(2, base_dir=str(tmp_path / "exec")) as pool:
        model = est.fit(table, backend=pool)
        assert model.getDevice() == "cpu"
        model.setInputMapping({"x": "x"}).setOutputMapping(
            {"out": "prediction"})
        model.setBatchSize(24).setClusterSize(2)
        if use_export:
            model.setModelDir(None)
        else:
            model.setExportDir(None).setModelName("linear_regression")
        out = model.transform(table, backend=pool)
    assert out.schema  # inferred from the first output row
    if use_export:
        loaded = export.load_saved_model(export_dir, device="cpu")
    else:
        assert not os.path.exists(export_dir)
        loaded = export.load_from_checkpoint(model_dir, "linear_regression",
                                             device="cpu")
    _check(tmp_path, table, out, loaded, "prediction", parts=2,
           batch_size=24)


def test_estimator_files_mode_with_export_fn(tmp_path):
    """FILES mode: the table materialised as TFRecords, each rank reads its
    shards; ``export_fn`` runs once, on an executor, after training."""
    table = _make_table()
    model_dir = str(tmp_path / "model")
    export_dir = str(tmp_path / "export")
    tfrecord_dir = str(tmp_path / "tfrecords")
    est = (
        pipeline.TFEstimator(progs.linreg_files, None,
                             export_fn=progs.export_linreg)
        .setInputMode(InputMode.FILES)
        .setTFRecordDir(tfrecord_dir)
        .setClusterSize(2)
        .setSteps(30)
        .setModelDir(model_dir)
        .setExportDir(export_dir)
        .setTimeout(100)
        .setDevice("cpu")
    )
    with backend_mod.LocalBackend(2, base_dir=str(tmp_path / "exec")) as pool:
        model = est.fit(table, backend=pool)
        assert len(dfutil.tfrecord_files(tfrecord_dir)) == 2
        model.setInputMapping({"x": "x"}).setBatchSize(64)
        out = model.transform(table, backend=pool)
    with open(os.path.join(export_dir, "export_fn.pid")) as f:
        assert int(f.read()) != os.getpid()
    loaded = export.load_saved_model(export_dir, device="cpu")
    mgr = CheckpointManager(model_dir)
    saved = mgr.restore_variables()
    mgr.close()
    for k, v in saved.items():
        assert torch.equal(loaded.variables[k], v)
    _check(tmp_path, table, out, loaded, "output", parts=2, batch_size=64)


def test_files_mode_origin_reuse(tmp_path):
    """A table loaded from TFRecords skips re-export (loadedDF semantics);
    the same table once changed is written out again."""
    src = _make_table(64)
    origin = str(tmp_path / "origin")
    dfutil.save_as_tfrecords(list(src), origin, schema=src.schema)
    loaded = dfutil.load_tfrecords(origin)

    est = (
        pipeline.TFEstimator(progs.linreg_files, None)
        .setInputMode(InputMode.FILES)
        .setClusterSize(1)
        .setSteps(1)
        .setModelDir(str(tmp_path / "model"))
        .setDevice("cpu")
    )
    with backend_mod.LocalBackend(1, base_dir=str(tmp_path / "exec")) as pool:
        est.fit(loaded, backend=pool)
        assert est._get("tfrecord_dir") == loaded.origin
        loaded.append(dict(loaded[0]))
        est.setTFRecordDir(str(tmp_path / "fresh"))
        with pytest.raises(ValueError, match="tfrecord_dir"):
            pipeline.TFEstimator(progs.linreg_files).setInputMode(
                InputMode.FILES)._fit(loaded, pool)
        est.fit(loaded, backend=pool)
    assert est._get("tfrecord_dir") == str(tmp_path / "fresh")
    assert len(dfutil.load_tfrecords(str(tmp_path / "fresh"))) == 65


def test_model_registrar_runs_on_each_executor(tmp_path):
    """An export of a user-registered model name serves only once the
    ``model_registrar`` has run in the executor; the registry of the
    driver is not the executor's."""
    model = factory.get_model("linear_regression", device="cpu", seed=4)
    d = str(tmp_path / "export")
    export.export_saved_model(d, progs.ALIAS, params=model.state_dict())
    table = _make_table(20)
    tf_model = (pipeline.TFModel().setExportDir(d).setInputMapping(
        {"x": "x"}).setBatchSize(8).setClusterSize(1).setDevice("cpu"))
    progs.register_alias()  # the driver's registry only
    with backend_mod.LocalBackend(1, base_dir=str(tmp_path / "exec")) as pool:
        with pytest.raises(RuntimeError, match="unknown model"):
            tf_model.transform(table, backend=pool)
        out = tf_model.setModelRegistrar(progs.register_alias).transform(
            table, backend=pool)
    with torch.no_grad():
        want = model(torch.as_tensor(_x(table))).numpy()
    np.testing.assert_array_equal(
        np.asarray([r["output"] for r in out], np.float32), want)
    assert factory.available() == sorted(factory.available())
    assert progs.ALIAS in factory.available()
