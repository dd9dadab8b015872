"""Checkpoint -> export-directory CLI (port of ``tools/model_export.py``).

The analog of the reference's ``examples/model_export.py`` (``:21-57``):
turn a training checkpoint (``train.checkpoint.CheckpointManager``'s
latest committed step) into a self-describing inference export with
JSON-specified signatures, without running the training program. With
``--example_shape`` the export also writes the ``torch.export`` serving
artifact, traced on the host (it serves on the card all the same:
``export.load_serving_model`` moves it).

Usage::

    python -m tensorflowonspark_tpu_torch.tools.model_export \\
        --model_dir /ckpts/run1 --export_dir /exports/run1 \\
        --model_name transformer --model_kwargs '{"vocab_size": 512}' \\
        --example_shape '[2, 128]' --example_dtype int32
"""

import argparse
import json
import logging

from tensorflowonspark_tpu_torch import export as export_lib
from tensorflowonspark_tpu_torch.tools import setup_logging


def build_parser():
    p = argparse.ArgumentParser(
        description="Export a training checkpoint for inference"
    )
    p.add_argument("--model_dir", required=True,
                   help="checkpoint directory written during training")
    p.add_argument("--export_dir", required=True,
                   help="output export directory")
    p.add_argument("--model_name", required=True,
                   help="registry model name (models.factory)")
    p.add_argument("--model_kwargs", default=None,
                   help="JSON dict of model constructor kwargs")
    p.add_argument("--signatures", default=None,
                   help="JSON signature dict {key: {inputs: {...}, "
                        "outputs: {...}}} (default: single x->out)")
    p.add_argument("--tag_set", default=export_lib.DEFAULT_TAG,
                   help="comma-separated export tags")
    p.add_argument("--example_shape", default=None,
                   help="JSON input shape (or {alias: shape} dict), batch "
                        "dim included, e.g. '[1, 224, 224, 3]'; enables "
                        "the torch.export serving artifact")
    p.add_argument("--example_dtype", default="float32",
                   help="input dtype for --example_shape")
    return p


def main(argv=None):
    setup_logging(logging.INFO)
    args = build_parser().parse_args(argv)
    model_kwargs = json.loads(args.model_kwargs) if args.model_kwargs else {}
    signatures = json.loads(args.signatures) if args.signatures else None

    from tensorflowonspark_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(args.model_dir)
    try:
        params, model_state = mgr.restore_variables(split=True)
    finally:
        mgr.close()
    example_inputs = None
    if args.example_shape:
        import numpy as np

        shape = json.loads(args.example_shape)
        if isinstance(shape, dict):
            example_inputs = {
                alias: np.zeros(s, args.example_dtype)
                for alias, s in shape.items()
            }
        else:
            example_inputs = np.zeros(shape, args.example_dtype)
    export_lib.export_saved_model(
        args.export_dir, args.model_name,
        params=params, model_state=model_state,
        model_kwargs=model_kwargs, signatures=signatures,
        tag_set=[t for t in args.tag_set.split(",") if t],
        example_inputs=example_inputs,
    )
    print(args.export_dir)


if __name__ == "__main__":
    main()
