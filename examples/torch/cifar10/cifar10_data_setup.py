"""CIFAR-10 data preparation (port of ``examples/cifar10/
cifar10_data_setup.py``): the same deterministic synthetic surrogate —
24x24x3 crops drawn from 10 class templates plus seeded noise — written as
TFRecord shards by the port's ``data.dfutil``.

Usage::

    python examples/torch/cifar10/cifar10_data_setup.py --output cifar10_data
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import common  # noqa: E402,F401

IMAGE = (24, 24, 3)


def synthesize(num_examples, seed=0):
    rng = np.random.RandomState(seed)
    trng = np.random.RandomState(4321)
    templates = np.zeros((10,) + IMAGE, np.float32)
    for c in range(10):
        for _ in range(2 + c % 4):
            cy, cx = trng.randint(2, 22, size=2)
            ch = trng.randint(0, 3)
            yy, xx = np.mgrid[0:24, 0:24]
            templates[c, :, :, ch] += np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2.0 * (2.0 + c / 4) ** 2)
            )
        templates[c] /= max(templates[c].max(), 1e-6)
    labels = rng.randint(0, 10, size=num_examples).astype(np.int64)
    noise = rng.rand(num_examples, *IMAGE).astype(np.float32) * 0.35
    images = templates[labels] * 0.65 + noise
    return images, labels


def main(argv=None):
    from tensorflowonspark_tpu_torch.data import dfutil

    p = argparse.ArgumentParser()
    p.add_argument("--output", default="cifar10_data")
    p.add_argument("--num_examples", type=int, default=20000)
    p.add_argument("--num_shards", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    images, labels = synthesize(args.num_examples, args.seed)
    rows = (
        {"image": images[i].reshape(-1), "label": int(labels[i])}
        for i in range(len(labels))
    )
    schema = {"image": dfutil.ARRAY_FLOAT, "label": dfutil.INT64}
    dfutil.save_as_tfrecords(rows, args.output, schema=schema,
                             num_shards=args.num_shards)
    print(args.output)


if __name__ == "__main__":
    main()
