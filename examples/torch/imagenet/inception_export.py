"""Export a trained Inception checkpoint as a serving model on the port
(port of ``examples/imagenet/inception_export.py``): the checkpoint's
parameters and BatchNorm statistics go into an export directory that
``export.load_saved_model`` and ``tools/inference.py`` read.

Run::

    python examples/torch/imagenet/inception_export.py \\
        --model_dir /tmp/inception_model --export_dir /tmp/inception_export \\
        --num_classes 50
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import common  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda",
                        help="cuda (default: the card; raises without one) "
                             "or cpu")
    parser.add_argument("--model_name", default="inception_v3")
    parser.add_argument("--model_dir", default="inception_model")
    parser.add_argument("--export_dir", required=True)
    parser.add_argument("--num_classes", type=int, default=1000)
    args = parser.parse_args(argv)
    common.use_device(args.device)

    from tensorflowonspark_tpu_torch import export
    from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(os.path.abspath(args.model_dir))
    try:
        params, model_state = mgr.restore_variables(split=True)
    finally:
        mgr.close()
    out = export.export_saved_model(
        os.path.abspath(args.export_dir), args.model_name,
        params=params, model_state=model_state,
        model_kwargs={"num_classes": args.num_classes + 1},
    )
    print(out)


if __name__ == "__main__":
    main()
