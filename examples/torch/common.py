"""Shared helpers for the port's example drivers (``examples/torch/``).

Each driver mirrors its JAX counterpart under ``examples/`` — the same
flags, defaults and seeded synthetic data — on the PyTorch port
(``tensorflowonspark_tpu_torch``), and imports nothing of JAX or of the JAX
package. ``--device`` takes the place of ``--cpu``: the default ``cuda``
needs a card and raises without one; ``--device cpu`` runs the driver and
its executors on the CPU.
"""

import math
import os
import sys

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                         ".."))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

# Executors on the CPU share the host: a few threads each.
CPU_THREADS = 2


def add_common_args(parser):
    parser.add_argument(
        "--device", default="cuda",
        help="cuda (default: the card; raises without one) or cpu")
    parser.add_argument("--cluster_size", type=int, default=2,
                        help="number of executor nodes")
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--steps", type=int, default=1000,
                        help="max train steps per node")
    return parser


def use_device(device):
    """Resolve ``device`` as every entry point of the port does (``cuda``
    without a card raises) and, on the CPU, cap this process's threads."""
    import torch

    from tensorflowonspark_tpu_torch import device_info

    dev = device_info.resolve_device(device)
    if dev.type == "cpu":
        torch.set_num_threads(CPU_THREADS)
    return dev


def cosine_decay(init_value, decay_steps):
    """``optax.cosine_decay_schedule(init_value, decay_steps)``."""
    def schedule(count):
        frac = min(count, decay_steps) / decay_steps
        return init_value * 0.5 * (1.0 + math.cos(math.pi * frac))
    return schedule


def exponential_decay(init_value, transition_steps, decay_rate):
    """``optax.exponential_decay`` (not staircase)."""
    return lambda count: init_value * decay_rate ** (count / transition_steps)


def clipped(make_base, schedule, max_norm=1.0):
    """An optimizer factory for ``train.Trainer``: the JAX examples'
    ``optax.chain(clip_by_global_norm(max_norm), base(schedule))``. The
    base optimizer (``make_base(params)``) takes the schedule's rate at
    each update; the update count lives in its first param group, so a
    checkpoint carries it."""
    import torch

    def make(params):
        opt = make_base(params)
        opt.param_groups[0].setdefault("update_count", 0)
        base_step = opt.step

        def step(closure=None):
            group = opt.param_groups[0]
            torch.nn.utils.clip_grad_norm_(
                [p for g in opt.param_groups for p in g["params"]], max_norm)
            for g in opt.param_groups:
                g["lr"] = schedule(group["update_count"])
            out = base_step(closure)
            group["update_count"] += 1
            return out

        opt.step = step
        return opt
    return make


def image_model(name, num_classes, image_size, device, **kw):
    """A zoo image model by registry name at ``image_size`` (the ResNets
    take any size and no such keyword)."""
    from tensorflowonspark_tpu_torch.models import factory

    if not name.startswith("resnet"):
        kw["image_size"] = image_size
    return factory.get_model(name, num_classes=num_classes,
                             device=str(device), **kw)


def accuracy_auc(prob, y):
    """Accuracy at 0.5 and the AUC by rank statistic (Mann-Whitney), the
    metrics the reference's CTR run logs report."""
    import numpy as np

    acc = float(((prob > 0.5).astype(np.int32) == y).mean())
    order = np.argsort(prob)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(prob) + 1)
    pos = y == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    auc = (ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    return acc, auc
