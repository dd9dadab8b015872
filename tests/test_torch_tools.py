"""The port's command-line tools held against the JAX package's.

``tools.model_export`` then ``tools.inference`` (checkpoint -> export ->
TFRecords -> JSON lines, predictions equal to the in-process ``predict``);
``tools.generate`` from an export and from a checkpoint, its greedy tokens
equal to the JAX CLI's on the same weights (fp32), with ``--auto_cache``,
``--chunked_cache`` and eos/pad; ``tools.reservation_client`` stopping a
server of either package. All on the CPU (``--device cpu``).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tensorflowonspark_tpu import export as jax_export
from tensorflowonspark_tpu.tools import generate as jax_generate
from tensorflowonspark_tpu_torch import convert, export
from tensorflowonspark_tpu_torch.data import dfutil
from tensorflowonspark_tpu_torch.models import decoding, factory
from tensorflowonspark_tpu_torch.tools import (
    generate, inference, model_export, reservation_client,
)
from tensorflowonspark_tpu_torch.train import checkpoint, trainer
from torch_export_common import flax_params

pytestmark = pytest.mark.watchdog_timeout(120)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# max_seq_len 256: a full-length cache spans two 128-slot chunks, so
# --chunked_cache walks more than one.
LM_KW = dict(vocab_size=64, num_layers=2, num_heads=4, embed_dim=32,
             mlp_dim=64, max_seq_len=256, remat=False, dtype="float32")
_STATE = {}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _save_checkpoint(model_dir, name, params, **kw):
    model = factory.get_model(name, device="cpu", **export._dekey(kw))
    tr = trainer.Trainer(model, optimizer=trainer.sgd(0.1), device="cpu")
    mgr = checkpoint.CheckpointManager(model_dir)
    mgr.save(tr.init(params=params), force=True)
    mgr.close()
    return model


def lm(tmp_path_factory):
    """The toy LM's weights: a JAX export, a port export and a port
    checkpoint of them (built once a module)."""
    if "lm" not in _STATE:
        root = tmp_path_factory.mktemp("lm")
        params = flax_params("transformer", LM_KW, np.zeros((1, 8), np.int32),
                             seed=5)
        jd, td, cd = (str(root / n) for n in ("jax", "port", "ckpt"))
        jax_export.export_saved_model(jd, "transformer", params=params,
                                      model_kwargs=LM_KW)
        cfg = factory.get_model("transformer", device="cpu",
                                **export._dekey(LM_KW)).cfg
        port = convert.params_from_flax(params, cfg)
        export.export_saved_model(td, "transformer", params=port,
                                  model_kwargs=LM_KW)
        _save_checkpoint(cd, "transformer", port, **LM_KW)
        prompts = root / "prompts.txt"
        prompts.write_text("1 2 3\n7 8 9 10 11 12 13\n")
        _STATE["lm"] = dict(jax=jd, port=td, ckpt=cd, prompts=str(prompts),
                            root=root)
    return _STATE["lm"]


def _rows(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f.read().splitlines()]


def _jax_cli(dirs, tag, flags):
    out = str(dirs["root"] / ("jax_" + tag + ".jsonl"))
    if not os.path.exists(out):
        jax_generate.main(["--export_dir", dirs["jax"], "--prompts_file",
                           dirs["prompts"], "--output", out] + flags)
    return _rows(out)


def _port_cli(tmp_path, source, flags):
    out = str(tmp_path / "port.jsonl")
    generate.main(source + ["--prompts_file", flags[0], "--output", out,
                            "--device", "cpu"] + flags[1:])
    return _rows(out)


def test_model_export_then_inference_cli(tmp_path, monkeypatch):
    """Checkpoint -> ``model_export`` (with the serving artifact) ->
    TFRecords -> ``inference`` over two executors: the JSON lines follow
    the input order and equal the in-process ``predict``."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.RandomState(11)
    params = flax_params("linear_regression", {},
                         np.zeros((2, 2), np.float32), seed=6)
    model = factory.get_model("linear_regression", device="cpu")
    port = convert.dense_params_from_flax(params, model)
    model_dir, export_dir = str(tmp_path / "ckpt"), str(tmp_path / "export")
    _save_checkpoint(model_dir, "linear_regression", port)
    model_export.main([
        "--model_dir", model_dir, "--export_dir", export_dir,
        "--model_name", "linear_regression",
        "--signatures", json.dumps({
            "serving_default": {"inputs": {"x": "features"},
                                "outputs": {"out": None}}}),
        "--tag_set", "serve,gpu",
        "--example_shape", "[4, 2]", "--example_dtype", "float32",
    ])
    manifest = export.read_manifest(export_dir)
    assert manifest["tag_set"] == ["gpu", "serve"]
    assert "serving_default" in manifest["torch_export"]

    x = rng.rand(40, 2).astype(np.float32)
    data_dir = str(tmp_path / "data")
    dfutil.save_as_tfrecords([{"features": r.tolist()} for r in x], data_dir,
                             num_shards=3)
    table = dfutil.load_tfrecords(data_dir)
    x = np.asarray([r["features"] for r in table], np.float32)
    out_dir = str(tmp_path / "preds")
    inference.main([
        "--export_dir", export_dir, "--input", data_dir,
        "--schema_hint", "struct<features:array<float>>",
        "--input_mapping", json.dumps({"features": "x"}),
        "--output_mapping", json.dumps({"out": "prediction"}),
        "--batch_size", "8", "--cluster_size", "2", "--tag_set", "gpu",
        "--output", out_dir, "--device", "cpu",
    ])
    preds = _rows(os.path.join(out_dir, "part-00000.jsonl"))
    assert len(preds) == 40
    got = np.asarray([p["prediction"] for p in preds], np.float32)
    for loaded in (export.load_serving_model(export_dir, device="cpu"),
                   export.load_saved_model(export_dir, prefer_aot=False,
                                           device="cpu")):
        np.testing.assert_allclose(got, loaded.predict(x)["out"],
                                   atol=1e-6, rtol=1e-6)
    decoding.load_variables(model, port)
    with torch.no_grad():
        direct = model(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, direct, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("source", ["export", "checkpoint"])
def test_generate_cli_greedy_equals_jax_cli(tmp_path, tmp_path_factory,
                                            source):
    dirs = lm(tmp_path_factory)
    if source == "export":
        src = ["--export_dir", dirs["port"]]
    else:
        src = ["--model_dir", dirs["ckpt"], "--model_name", "transformer",
               "--model_kwargs", json.dumps(LM_KW)]
    got = _port_cli(tmp_path, src, [dirs["prompts"], "--max_new_tokens",
                                    "12"])
    want = _jax_cli(dirs, "plain", ["--max_new_tokens", "12"])
    assert got == want
    assert [len(r["tokens"]) for r in got] == [15, 19]


@pytest.mark.parametrize("flags", [
    ["--auto_cache"], ["--chunked_cache"], ["--chunked_cache", "--auto_cache"],
    ["--eos_token", "7", "--pad_token", "0"],
], ids=["auto", "chunked", "chunked_auto", "eos_pad"])
def test_generate_cli_flags_equal_jax_cli(tmp_path, tmp_path_factory, flags):
    dirs = lm(tmp_path_factory)
    tag = "_".join(f.strip("-") for f in flags)
    got = _port_cli(tmp_path, ["--export_dir", dirs["port"]],
                    [dirs["prompts"], "--max_new_tokens", "12"] + flags)
    assert got == _jax_cli(dirs, tag, ["--max_new_tokens", "12"] + flags)
    assert got == _jax_cli(dirs, "plain", ["--max_new_tokens", "12"]) or \
        "--eos_token" in flags


def test_generate_cli_sampling_is_seeded(tmp_path, tmp_path_factory):
    """Sampled streams repeat under one ``--seed``, differ under another,
    and keep to the top-k set (the draws are the port's own)."""
    dirs = lm(tmp_path_factory)
    flags = ["--max_new_tokens", "16", "--temperature", "1.0", "--top_k",
             "8", "--top_p", "0.9"]
    runs = [_port_cli(tmp_path, ["--export_dir", dirs["port"]],
                      [dirs["prompts"]] + flags + ["--seed", s])
            for s in ("3", "3", "4")]
    assert runs[0] == runs[1] and runs[0] != runs[2]
    assert all(0 <= t < 64 for r in runs[0] for t in r["tokens"])
    a = generate.prompt_generator(3, 0, "cpu")
    b = generate.prompt_generator(3, 1, "cpu")
    assert torch.rand(4, generator=a).tolist() != \
        torch.rand(4, generator=b).tolist()


def test_generate_cli_needs_a_model_and_a_prompt(capsys):
    with pytest.raises(SystemExit):
        generate.main(["--prompt", "1 2"])
    with pytest.raises(SystemExit):
        generate.main(["--export_dir", "x"])
    assert "need" in capsys.readouterr().err


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
def test_reservation_client_cli(server_pkg):
    """The port's CLI, in a process of its own, stops a server of either
    package (the frames are byte-equal)."""
    if server_pkg == "jax":
        from tensorflowonspark_tpu import reservation
    else:
        from tensorflowonspark_tpu_torch import reservation
    server = reservation.Server(1)
    host, port = server.start()
    try:
        assert not server.done.is_set()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["PYTHONPATH"] = ROOT
        res = subprocess.run(
            [sys.executable, "-m",
             "tensorflowonspark_tpu_torch.tools.reservation_client", host,
             str(port)], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=100)
        assert res.returncode == 0, res.stderr
        assert "stop requested" in res.stdout
        assert server.done.wait(5)
    finally:
        server.stop()
    server = reservation.Server(1)
    host, port = server.start()
    try:
        reservation_client.main([host, str(port)])
        assert server.done.wait(5)
    finally:
        server.stop()
