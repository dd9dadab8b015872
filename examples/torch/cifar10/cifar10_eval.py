"""CIFAR-10 eval on the port (port of ``examples/cifar10/cifar10_eval.py``):
precision@1 over a held-out set from the latest checkpoint.

Run::

    python examples/torch/cifar10/cifar10_eval.py --data_dir /tmp/c10 \\
        --model_dir /tmp/cifar10_model
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import common  # noqa: E402

IMAGE = (24, 24, 3)


def main(argv=None):
    parser = common.add_common_args(argparse.ArgumentParser())
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--model_dir", default="cifar10_model")
    parser.add_argument("--num_examples", type=int, default=2048)
    args = parser.parse_args(argv)
    device = common.use_device(args.device)

    import numpy as np

    from tensorflowonspark_tpu_torch import export
    from tensorflowonspark_tpu_torch.data import dfutil

    loaded = export.load_from_checkpoint(
        os.path.abspath(args.model_dir), "cifarnet", device=str(device))
    rows = dfutil.load_tfrecords(os.path.abspath(args.data_dir))
    rows = rows[:args.num_examples]

    correct = total = 0
    for lo in range(0, len(rows), args.batch_size):
        chunk = rows[lo:lo + args.batch_size]
        x = np.stack([
            np.asarray(r["image"], np.float32).reshape(IMAGE) for r in chunk
        ])
        y = np.asarray([int(r["label"]) for r in chunk])
        preds = np.argmax(loaded.predict({"x": x})["out"], axis=-1)
        correct += int((preds == y).sum())
        total += len(chunk)
    print("precision @ 1 = {:.3f} ({} examples)".format(
        correct / float(total), total))


if __name__ == "__main__":
    main()
