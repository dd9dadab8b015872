"""ImageNet-surrogate data preparation (port of ``examples/imagenet/
imagenet_data_setup.py``): the same deterministic synthetic surrogate —
float pixels (or, with ``--jpeg``, ``image/encoded`` JPEG bytes) and an
int64 label in [1, num_classes], 0 kept as background — written as TFRecord
shards by the port's ``data`` tier.

Usage::

    python examples/torch/imagenet/imagenet_data_setup.py \\
        --output imagenet_data --image_size 75 --num_classes 50
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import common  # noqa: E402,F401


def synthesize(num_examples, image_size, num_classes, seed=0):
    rng = np.random.RandomState(seed)
    trng = np.random.RandomState(31337)
    templates = np.zeros((num_classes, image_size, image_size, 3), np.float32)
    for c in range(num_classes):
        for _ in range(3):
            cy, cx = trng.randint(4, image_size - 4, size=2)
            ch = trng.randint(0, 3)
            yy, xx = np.mgrid[0:image_size, 0:image_size]
            sigma = 2.0 + (c % 7)
            templates[c, :, :, ch] += np.exp(
                -((yy - cy) ** 2 + (xx - cx) ** 2) / (2.0 * sigma ** 2)
            )
        templates[c] /= max(templates[c].max(), 1e-6)
    labels = rng.randint(1, num_classes + 1, size=num_examples).astype(np.int64)
    noise = rng.rand(num_examples, image_size, image_size, 3).astype(np.float32)
    images = templates[labels - 1] * 0.6 + noise * 0.4
    return images, labels


def main(argv=None):
    from tensorflowonspark_tpu_torch.data import dfutil

    p = argparse.ArgumentParser()
    p.add_argument("--output", default="imagenet_data")
    p.add_argument("--num_examples", type=int, default=4096)
    p.add_argument("--num_shards", type=int, default=8)
    p.add_argument("--image_size", type=int, default=75)
    p.add_argument("--num_classes", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--jpeg", action="store_true",
                   help="write image/encoded JPEG bytes + label — the "
                        "reference's shard layout")
    args = p.parse_args(argv)

    images, labels = synthesize(args.num_examples, args.image_size,
                                args.num_classes, args.seed)
    if args.jpeg:
        from tensorflowonspark_tpu_torch.data import image_preprocessing as ip

        rows = (
            {"image/encoded": ip.encode_jpeg(
                (images[i] * 255).astype(np.uint8)),
             "label": int(labels[i])}
            for i in range(len(labels))
        )
        schema = {"image/encoded": dfutil.BINARY, "label": dfutil.INT64}
    else:
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
