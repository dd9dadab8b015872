"""ImageNet eval on the port (port of ``examples/imagenet/
imagenet_eval.py``): precision@1 and recall@5 from the latest checkpoint.

Run::

    python examples/torch/imagenet/imagenet_eval.py --data_dir /tmp/inet \\
        --model_dir /tmp/inception_model --image_size 75 --num_classes 50
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import common  # noqa: E402


def main(argv=None):
    parser = common.add_common_args(argparse.ArgumentParser())
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--model_name", default="inception_v3")
    parser.add_argument("--model_dir", default="inception_model")
    parser.add_argument("--image_size", type=int, default=299)
    parser.add_argument("--num_classes", type=int, default=1000)
    parser.add_argument("--num_examples", type=int, default=1024)
    args = parser.parse_args(argv)
    device = common.use_device(args.device)

    import numpy as np

    from tensorflowonspark_tpu_torch import export
    from tensorflowonspark_tpu_torch.data import dfutil

    shape = (args.image_size, args.image_size, 3)
    kwargs = {"num_classes": args.num_classes + 1}
    if not args.model_name.startswith("resnet"):
        kwargs["image_size"] = args.image_size
    loaded = export.load_from_checkpoint(
        os.path.abspath(args.model_dir), args.model_name,
        model_kwargs=kwargs, device=str(device))
    rows = dfutil.load_tfrecords(os.path.abspath(args.data_dir))
    rows = rows[:args.num_examples]

    top1 = top5 = total = 0
    for lo in range(0, len(rows), args.batch_size):
        chunk = rows[lo:lo + args.batch_size]
        x = np.stack([
            np.asarray(r["image"], np.float32).reshape(shape) for r in chunk
        ])
        y = np.asarray([int(r["label"]) for r in chunk])
        logits = np.asarray(loaded.predict({"x": x})["out"])
        order = np.argsort(-logits, axis=-1)
        top1 += int((order[:, 0] == y).sum())
        top5 += int((order[:, :5] == y[:, None]).any(axis=1).sum())
        total += len(chunk)
    print("precision @ 1 = {:.4f}  recall @ 5 = {:.4f} [{} examples]".format(
        top1 / float(total), top5 / float(total), total))


if __name__ == "__main__":
    main()
