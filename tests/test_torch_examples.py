"""The port's example drivers (``examples/torch/``) end to end on the CPU
(``--device cpu``), each a subprocess at the sizes of the JAX examples'
tests (``tests/test_examples_vision.py``, ``tests/test_examples_misc.py``):
CIFAR-10 data setup, train (inline and as a two-executor FILES cluster)
and eval; the slim universal trainer on float and JPEG shards; ImageNet
data setup, Inception train over the feed plane (two executors), eval and
export; wide & deep and Criteo over the feed plane. The drivers import
nothing of JAX (``tests/test_torch_isolation.py`` walks them).
"""

import json
import os
import subprocess
import sys

import pytest

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "torch")
TIMEOUT = 120

pytestmark = pytest.mark.watchdog_timeout(120)


def _run(args, cwd):
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, *args[0])] + args[1:]
        + ["--device", "cpu"], cwd=cwd, env=dict(os.environ),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=TIMEOUT)
    out = proc.stdout.decode(errors="replace")
    assert proc.returncode == 0, out[-4000:]
    return out


def _setup(args, cwd):
    """Data setup takes no ``--device``."""
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, *args[0])] + args[1:],
        cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout.decode(errors="replace")[-4000:]


@pytest.fixture(scope="module")
def cifar_data(tmp_path_factory):
    base = tmp_path_factory.mktemp("cifar")
    data = str(base / "data")
    _setup([("cifar10", "cifar10_data_setup.py"), "--output", data,
            "--num_examples", "128", "--num_shards", "2"], str(base))
    return data


@pytest.fixture(scope="module")
def imagenet_data(tmp_path_factory):
    base = tmp_path_factory.mktemp("inet")
    data = str(base / "data")
    _setup([("imagenet", "imagenet_data_setup.py"), "--output", data,
            "--num_examples", "64", "--num_shards", "2", "--image_size", "32",
            "--num_classes", "5"], str(base))
    return data


@pytest.mark.parametrize("distributed", [False, True],
                         ids=["inline", "two_executors"])
def test_cifar10_train_then_eval(cifar_data, tmp_path, distributed):
    model_dir = str(tmp_path / "m")
    extra = ["--distributed", "--cluster_size", "2"] if distributed else []
    out = _run([("cifar10", "cifar10_train.py"), "--data_dir", cifar_data,
                "--model_dir", model_dir, "--steps", "10", "--batch_size",
                "32"] + extra, str(tmp_path))
    assert "step 10, loss" in out
    out = _run([("cifar10", "cifar10_eval.py"), "--data_dir", cifar_data,
                "--model_dir", model_dir, "--num_examples", "64",
                "--batch_size", "32"], str(tmp_path))
    assert "precision @ 1" in out and "(64 examples)" in out


def test_slim_universal_trainer(cifar_data, tmp_path):
    out = _run([("slim", "train_image_classifier.py"), "--dataset_dir",
                cifar_data, "--model_name", "cifarnet", "--image_size", "24",
                "--num_classes", "10", "--model_dir", str(tmp_path / "m"),
                "--steps", "10", "--batch_size", "32"], str(tmp_path))
    assert "cifarnet: step 10" in out and "final accuracy" in out


def test_slim_trainer_jpeg_pipeline(tmp_path):
    data = str(tmp_path / "jpeg_data")
    _setup([("imagenet", "imagenet_data_setup.py"), "--output", data,
            "--num_examples", "96", "--image_size", "32", "--num_classes",
            "4", "--jpeg", "--num_shards", "2"], str(tmp_path))
    out = _run([("slim", "train_image_classifier.py"), "--dataset_dir", data,
                "--model_name", "cifarnet", "--image_size", "24",
                "--num_classes", "5", "--model_dir", str(tmp_path / "m"),
                "--steps", "4", "--batch_size", "16", "--jpeg"],
               str(tmp_path))
    assert "preprocessing style: cifarnet" in out and "final accuracy" in out


def test_inception_train_eval_export(imagenet_data, tmp_path):
    model_dir = str(tmp_path / "m")
    export_dir = str(tmp_path / "export")
    out = _run([("imagenet", "inception_train.py"), "--data_dir",
                imagenet_data, "--model_name", "inception_v1",
                "--image_size", "32", "--num_classes", "5", "--model_dir",
                model_dir, "--steps", "3", "--batch_size", "16",
                "--cluster_size", "2"], str(tmp_path))
    assert "model written to" in out
    out = _run([("imagenet", "imagenet_eval.py"), "--data_dir",
                imagenet_data, "--model_name", "inception_v1", "--model_dir",
                model_dir, "--image_size", "32", "--num_classes", "5",
                "--num_examples", "32", "--batch_size", "16"], str(tmp_path))
    assert "precision @ 1" in out and "[32 examples]" in out
    _run([("imagenet", "inception_export.py"), "--model_name",
          "inception_v1", "--model_dir", model_dir, "--export_dir",
          export_dir, "--num_classes", "5"], str(tmp_path))
    with open(os.path.join(export_dir, "saved_model.json")) as f:
        manifest = json.load(f)
    assert manifest["model"] == "inception_v1"
    assert manifest["model_kwargs"] == {"num_classes": 6}


def test_wide_deep(tmp_path):
    out = _run([("wide_deep", "wide_deep.py"), "--model_dir",
                str(tmp_path / "m"), "--num_examples", "256", "--steps", "5",
                "--batch_size", "64"], str(tmp_path))
    assert "AUC = " in out


def test_criteo(tmp_path):
    out = _run([("criteo", "criteo.py"), "--model_dir", str(tmp_path / "m"),
                "--num_examples", "512", "--steps", "5", "--batch_size",
                "64"], str(tmp_path))
    assert "AUC = " in out


def test_drivers_refuse_cuda_without_a_card(tmp_path):
    """The default ``--device cuda`` raises without a card; nothing runs
    on the CPU unasked."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, "wide_deep", "wide_deep.py"),
         "--model_dir", str(tmp_path / "m"), "--steps", "1"],
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        timeout=TIMEOUT)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stdout.decode(errors="replace")
