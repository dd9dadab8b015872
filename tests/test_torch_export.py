"""The port's export plane held against the JAX package's ``export.py``.

Mirrors ``tests/test_export.py``: export, load and predict; signatures and
tags; checkpoint restore; the code-free serving artifact (here a
``torch.export`` program); the dense/contiguous coercion — plus the
port's own contracts: a dtype written by name and read back, a JAX
``variables.msgpack`` refused, greedy ``generate`` equal to JAX's, and the
engine behind ``serving_engine()`` equal to the port's ``generate``.

Weights are seeded numpy arrays in the flax layout (no JAX mesh, no JAX
``Trainer``): the JAX export takes them as they are, the port's through
``convert``. Predictions are held to 1e-5 (f32); greedy tokens exactly.
The JAX references are built lazily, once a module.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu import export as jax_export
from tensorflowonspark_tpu_torch import convert, export
from tensorflowonspark_tpu_torch.models import decoding, factory
from tensorflowonspark_tpu_torch.train import checkpoint, trainer
from torch_export_common import flax_params

pytestmark = pytest.mark.watchdog_timeout(120)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_KW = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32,
             mlp_dim=64, max_seq_len=128, remat=False, dtype="float32")
TOL = 1e-5
_STATE = {}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def linreg():
    if "linreg" not in _STATE:
        params = flax_params("linear_regression", {},
                              np.zeros((4, 2), np.float32), seed=1)
        tm = factory.get_model("linear_regression", device="cpu")
        _STATE["linreg"] = (params,
                            convert.dense_params_from_flax(params, tm))
    return _STATE["linreg"]


def lm_params():
    """(flax params, the port's state_dict) of the toy LM."""
    if "lm" not in _STATE:
        params = flax_params("transformer", LM_KW,
                              np.zeros((1, 8), np.int32), seed=2)
        cfg = factory.get_model("transformer", device="cpu",
                                **export._dekey(LM_KW)).cfg
        _STATE["lm"] = (params, convert.params_from_flax(params, cfg))
    return _STATE["lm"]


def _tokens(shape, seed):
    return np.random.RandomState(seed).randint(
        1, LM_KW["vocab_size"], size=shape).astype(np.int32)


def _jax_dir(tmp_path_factory, key, name, params, kw, **extra):
    """A JAX export of ``params`` (built once a module)."""
    if key not in _STATE:
        d = str(tmp_path_factory.mktemp(key))
        jax_export.export_saved_model(d, name, params=params,
                                      model_kwargs=kw, **extra)
        _STATE[key] = d
    return _STATE[key]


CASES = {
    "linear_regression": ("linear_regression", {}, (5, 2)),
    "transformer_dense": ("transformer", dict(LM_KW, attention_impl="dense"),
                          (3, 24)),
    "transformer_pallas": ("transformer",
                           dict(LM_KW, attention_impl="pallas"), (3, 24)),
}


def _case_inputs(shape, seed=3):
    if len(shape) == 2 and shape[1] == 2:
        return np.random.RandomState(seed).rand(*shape).astype(np.float32)
    return _tokens(shape, seed)


def _case_params(name):
    return linreg() if name == "linear_regression" else lm_params()


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_load_predict_parity(tmp_path, tmp_path_factory, case):
    """Port export -> load -> predict against JAX ``LoadedModel.predict``
    on the same weights (the pallas route: JAX's kernel in interpret mode,
    the port's plain versions)."""
    name, kw, shape = CASES[case]
    flax_params, port_params = _case_params(name)
    x = _case_inputs(shape)
    jdir = _jax_dir(tmp_path_factory, "jax_" + case, name, flax_params, kw)
    want = jax_export.load_saved_model(jdir).predict({"x": x})["out"]

    d = str(tmp_path / "export")
    export.export_saved_model(d, name, params=port_params, model_kwargs=kw)
    loaded = export.load_saved_model(d, device="cpu")
    assert loaded.model is not None
    got = loaded.predict({"x": x})["out"]
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # A bare array feeds a single-input signature; a tensor on the device
    # passes straight through.
    np.testing.assert_array_equal(loaded.predict(x)["out"], got)
    np.testing.assert_array_equal(
        loaded.predict(torch.as_tensor(x))["out"], got)


def test_manifest_shared_keys_equal_jax(tmp_path):
    flax_params, port_params = lm_params()
    sigs = {"score": {"inputs": {"x": "tokens"}, "outputs": {"logits": None}},
            "serving_default": {"inputs": {"x": "x"},
                                "outputs": {"out": None}}}
    kw = dict(LM_KW, attention_impl="pallas", num_kv_heads=0)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_export.export_saved_model(jd, "transformer", params=flax_params,
                                  model_kwargs=kw, signatures=sigs,
                                  tag_set=("serve", "gpu"))
    # The port takes a torch dtype and the runtime keywords; the manifest
    # holds neither the dtype object nor device/seed.
    port_kw = dict(kw, dtype=torch.float32, device="cpu", seed=5)
    export.export_saved_model(td, "transformer", params=port_params,
                              model_kwargs=port_kw, signatures=sigs,
                              tag_set=("serve", "gpu"))
    jm, tm = jax_export.read_manifest(jd), export.read_manifest(td)
    for key in ("format_version", "model", "model_kwargs", "signatures",
                "tag_set"):
        assert tm[key] == jm[key], key
    assert os.path.exists(os.path.join(td, export.VARIABLES))
    tree = torch.load(os.path.join(td, export.VARIABLES), weights_only=True)
    assert sorted(tree) == ["model_state", "params"]
    assert set(tree["params"]) == set(port_params)


def test_signature_and_tag_validation(tmp_path):
    _, port_params = linreg()
    d = str(tmp_path / "export")
    export.export_saved_model(
        d, "linear_regression", params=port_params,
        signatures={"score": {"inputs": {"x": "features"},
                              "outputs": {"pred": None}}},
        tag_set=("serve", "tpu"),
    )
    loaded = export.load_saved_model(d, signature_def_key="score",
                                     tag_set="tpu", device="cpu")
    assert loaded.output_aliases == ["pred"]
    assert loaded.input_aliases == ["x"]
    x = _case_inputs((3, 2))
    # Keyed by the bound column as well as by the alias.
    np.testing.assert_array_equal(loaded.predict({"features": x})["pred"],
                                  loaded.predict({"x": x})["pred"])
    with pytest.raises(KeyError, match="missing input"):
        loaded.predict({"other": x})
    with pytest.raises(ValueError, match="signature"):
        export.load_saved_model(d, signature_def_key="missing", device="cpu")
    with pytest.raises(ValueError, match="tag_set"):
        export.load_saved_model(d, signature_def_key="score", tag_set="gpu",
                                device="cpu")


def test_checkpoint_restore_variables(tmp_path, tmp_path_factory):
    """A committed training checkpoint serves through
    ``load_from_checkpoint``: its predictions equal the exported model's
    and JAX's on the same weights."""
    flax_params, port_params = linreg()
    model = factory.get_model("linear_regression", device="cpu")
    decoding.load_variables(model, port_params)
    tr = trainer.Trainer(model, optimizer=trainer.sgd(0.5), device="cpu")
    state = tr.init(params=port_params)
    model_dir = str(tmp_path / "ckpt")
    mgr = checkpoint.CheckpointManager(model_dir)
    mgr.save(state, force=True)
    mgr.close()
    loaded = export.load_from_checkpoint(model_dir, "linear_regression",
                                         device="cpu")
    x = _case_inputs((4, 2))
    jdir = _jax_dir(tmp_path_factory, "jax_linear_regression",
                    "linear_regression", flax_params, {})
    want = jax_export.load_saved_model(jdir).predict({"x": x})["out"]
    np.testing.assert_allclose(loaded.predict({"x": x})["out"], want,
                               atol=TOL, rtol=TOL)
    # The split restore is what the export CLI writes.
    mgr = checkpoint.CheckpointManager(model_dir)
    params, model_state = mgr.restore_variables(split=True)
    mgr.close()
    assert set(params) == set(port_params) and model_state == {}


def test_checkpoint_missing(tmp_path):
    missing = str(tmp_path / "nope")
    with pytest.raises(FileNotFoundError):
        export.load_from_checkpoint(missing, "linear_regression",
                                    device="cpu")
    assert not os.path.exists(missing)
    os.makedirs(missing)
    with pytest.raises(FileNotFoundError):
        export.load_from_checkpoint(missing, "linear_regression",
                                    device="cpu")


@pytest.mark.parametrize("case", ["linear_regression", "transformer_pallas"])
def test_aot_serving_artifact_roundtrip(tmp_path, tmp_path_factory, case):
    """The ``torch.export`` artifact, traced at an example batch of 4,
    serves batches 1, 2 and 10 and agrees with JAX's predict."""
    name, kw, shape = CASES[case]
    flax_params, port_params = _case_params(name)
    d = str(tmp_path / "export_aot")
    example = np.zeros((4,) + shape[1:], _case_inputs(shape).dtype)
    export.export_saved_model(d, name, params=port_params, model_kwargs=kw,
                              example_inputs=example)
    manifest = export.read_manifest(d)
    assert manifest["torch_export"] == {
        "serving_default": "torch_export/serving_default.pt2"}
    loaded = export.load_serving_model(d, device="cpu")
    assert loaded.model is None
    jdir = _jax_dir(tmp_path_factory, "jax_" + case, name, flax_params, kw)
    jloaded = jax_export.load_saved_model(jdir)
    for batch in (1, 2, 10):
        x = _case_inputs((batch,) + shape[1:], seed=batch)
        got = loaded.predict({"x": x})["out"]
        assert got.shape[0] == batch
        np.testing.assert_allclose(got, jloaded.predict(x)["out"],
                                   atol=TOL, rtol=TOL)
    # The program holds no weights: the variables file is the only copy.
    program = torch.export.load(os.path.join(d, manifest["torch_export"][
        "serving_default"]))
    assert dict(program.state_dict) == {} and dict(program.constants) == {}
    assert program.example_inputs is None
    with pytest.raises(ValueError, match="generation needs the registry"):
        loaded.generate(_tokens((1, 4), 0), 2)
    with pytest.raises(ValueError, match="serving needs the registry"):
        loaded.serving_engine()


_NO_MODELS = r"""
import json, sys
import numpy as np
from tensorflowonspark_tpu_torch import export
loaded = export.load_serving_model(sys.argv[1], device="cpu")
x = np.load(sys.argv[2])
np.save(sys.argv[3], loaded.predict({"x": x})["out"])
print(json.dumps(sorted(m for m in sys.modules
                        if m.startswith("tensorflowonspark_tpu"))))
"""


def test_aot_serving_survives_without_model_code(tmp_path, monkeypatch):
    """Export -> make model code unavailable -> infer still works; in a
    fresh interpreter, load and predict import no ``models`` module."""
    _, port_params = lm_params()
    kw = CASES["transformer_dense"][1]
    d = str(tmp_path / "export_aot2")
    export.export_saved_model(d, "transformer", params=port_params,
                              model_kwargs=kw,
                              example_inputs=np.zeros((4, 16), np.int32))
    x = _tokens((2, 16), 7)
    want = export.load_saved_model(d, prefer_aot=False,
                                   device="cpu").predict(x)["out"]

    def gone(*a, **k):
        raise AssertionError("model registry must not be touched")

    monkeypatch.setattr(factory, "get_model", gone)
    out = export.load_serving_model(d, device="cpu").predict(x)["out"]
    np.testing.assert_allclose(out, want, atol=TOL, rtol=TOL)
    # load_saved_model prefers the artifact (no registry either).
    np.testing.assert_array_equal(
        export.load_saved_model(d, device="cpu").predict(x)["out"], out)

    np.save(str(tmp_path / "x.npy"), x)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run(
        [sys.executable, "-c", _NO_MODELS, d, str(tmp_path / "x.npy"),
         str(tmp_path / "y.npy")], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=100)
    assert res.returncode == 0, res.stderr
    loaded_mods = json.loads(res.stdout.strip().splitlines()[-1])
    assert "tensorflowonspark_tpu_torch.export" in loaded_mods
    assert [m for m in loaded_mods
            if m.startswith("tensorflowonspark_tpu_torch.models")] == []
    np.testing.assert_array_equal(np.load(str(tmp_path / "y.npy")), out)


def test_load_serving_model_requires_artifact(tmp_path):
    _, port_params = linreg()
    d = str(tmp_path / "export_plain")
    export.export_saved_model(d, "linear_regression", params=port_params)
    with pytest.raises(ValueError, match="no AOT serving artifact"):
        export.load_serving_model(d, device="cpu")


@pytest.mark.parametrize("route", [
    dict(attention_impl="pallas"),
    dict(attention_impl="ring_flash", ring_layout="zigzag"),
], ids=["pallas", "ring_flash_zigzag"])
def test_aot_export_forces_dense_contiguous(tmp_path, caplog, route):
    """The artifact runs dense attention on the contiguous layout whatever
    the model trained with, and agrees with JAX's artifact of the same
    export (both coerced)."""
    flax_params, port_params = lm_params()
    kw = dict(LM_KW, **route)
    tokens = _tokens((2, 8), 4)
    td, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    with caplog.at_level("INFO", logger=export.logger.name):
        export.export_saved_model(td, "transformer", params=port_params,
                                  model_kwargs=kw, example_inputs=tokens)
    assert "forcing attention_impl='dense'" in caplog.text
    # The manifest keeps the trained configuration.
    assert export.read_manifest(td)["model_kwargs"]["attention_impl"] == \
        route["attention_impl"]
    jax_export.export_saved_model(jd, "transformer", params=flax_params,
                                  model_kwargs=kw, example_inputs=tokens)
    got = export.load_serving_model(td, device="cpu").predict(
        {"x": tokens})["out"]
    want = jax_export.load_serving_model(jd).predict({"x": tokens})["out"]
    assert got.shape == (2, 8, 64)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_dtype_name_round_trip(tmp_path):
    """A torch dtype is written by name and read back as the dtype; the
    names of the JAX package's manifests load the same way."""
    _, port_params = lm_params()
    d = str(tmp_path / "bf16")
    kw = dict(LM_KW, dtype=torch.bfloat16, num_kv_heads=0)
    export.export_saved_model(d, "transformer", params=port_params,
                              model_kwargs=kw)
    manifest = export.read_manifest(d)
    assert manifest["model_kwargs"]["dtype"] == "bfloat16"
    loaded = export.load_saved_model(d, device="cpu")
    assert loaded.model.cfg.dtype is torch.bfloat16
    assert loaded.variables["pos_embed"].dtype == torch.float32
    out = loaded.predict(_tokens((1, 8), 0))["out"]
    assert out.dtype == np.float32 and np.isfinite(out).all()
    assert export._dekey({"dtype": "float32", "shape": [1, 2],
                          "kv_quant": "int8"}) == {
        "dtype": torch.float32, "shape": (1, 2), "kv_quant": "int8"}
    with pytest.raises(ValueError, match="names no torch dtype"):
        export._dekey({"dtype": "float33"})
    with pytest.raises(TypeError, match="not a JSON value"):
        export._jsonable({"init": object()})


def test_jax_variables_refused(tmp_path_factory):
    flax_params, _ = linreg()
    jdir = _jax_dir(tmp_path_factory, "jax_linear_regression",
                    "linear_regression", flax_params, {})
    assert os.path.exists(os.path.join(jdir, "variables.msgpack"))
    with pytest.raises(ValueError, match="variables.msgpack"):
        export.load_saved_model(jdir, device="cpu")


def test_entry_points_default_to_the_card(tmp_path):
    """Without a card the loaders raise unless asked for the CPU, and the
    TensorFlow SavedModel export names its ROADMAP item."""
    _, port_params = linreg()
    d = str(tmp_path / "export")
    export.export_saved_model(d, "linear_regression", params=port_params,
                              example_inputs=np.zeros((2, 2), np.float32))
    if not torch.cuda.is_available():
        for load in (export.load_saved_model, export.load_serving_model):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                load(d)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            export.load_from_checkpoint(d, "linear_regression")
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        export.export_saved_model(str(tmp_path / "tf"), "linear_regression",
                                  params=port_params, tf_saved_model=True)
    assert not os.path.exists(str(tmp_path / "tf"))


def test_generate_greedy_equals_jax(tmp_path, tmp_path_factory):
    """fp32 greedy tokens of ``LoadedModel.generate`` equal JAX's."""
    flax_params, port_params = lm_params()
    kw = CASES["transformer_dense"][1]
    jdir = _jax_dir(tmp_path_factory, "jax_transformer_dense", "transformer",
                    flax_params, kw)
    d = str(tmp_path / "export")
    export.export_saved_model(d, "transformer", params=port_params,
                              model_kwargs=kw)
    loaded = export.load_saved_model(d, device="cpu")
    prompt = _tokens((2, 6), 9)
    want = np.asarray(jax_export.load_saved_model(jdir).generate(prompt, 10))
    got = loaded.generate(prompt, 10)
    np.testing.assert_array_equal(got.numpy(), want)


def test_serving_engine_streams_equal_generate(tmp_path):
    """``serving_engine()`` (the JAX defaults: horizon 8, prefix sharing,
    swap preemption) serves the export's weights cast to the serving
    dtype; its greedy streams equal the port's ``generate`` on those
    weights bitwise, and ``predict`` keeps the export's own weights."""
    _, port_params = lm_params()
    kw = CASES["transformer_dense"][1]
    d = str(tmp_path / "export")
    export.export_saved_model(d, "transformer", params=port_params,
                              model_kwargs=kw)
    loaded = export.load_saved_model(d, device="cpu")
    x = _tokens((2, 12), 3)
    before = loaded.predict(x)["out"]
    eng = loaded.serving_engine(max_slots=4, page_size=16, num_pages=32)
    prompts = [_tokens((n,), 20 + n) for n in (5, 17, 9)]
    handles = [eng.submit(p, 12) for p in prompts]
    eng.run_until_idle()
    assert eng.pool.pages_in_use == 0
    solo = factory.get_model("transformer", device="cpu",
                             **export._dekey(kw))
    served = decoding.serving_variables(loaded.variables)
    for p, h in zip(prompts, handles):
        want = decoding.generate(solo, served, p[None], 12, auto_cache=True)
        assert h.result(timeout=5) == want[0, len(p):].tolist()
    np.testing.assert_array_equal(loaded.predict(x)["out"], before)
