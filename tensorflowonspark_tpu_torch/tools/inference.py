"""Batch-inference CLI: TFRecords in, JSON predictions out (port of
``tools/inference.py``).

The analog of the reference's Scala ``Inference.scala`` app (``:27-79``):
load a TFRecord dataset (``data.dfutil.load_tfrecords``, with an optional
``struct<...>`` schema hint), run the exported model over it with
input/output mappings through ``pipeline.TFModel``, and write one JSON
object per row, in input order.

Batches are device-prefetched (``train.prefetch.DevicePrefetch`` inside
``pipeline._RunModel``): feed assembly and the host->device copy of batch
N+1 overlap the forward pass of batch N. Executors load the model onto
``--device`` (the card by default; ``cpu`` runs on the host).

Usage::

    python -m tensorflowonspark_tpu_torch.tools.inference \\
        --export_dir /exports/run1 --input /data/test \\
        --schema_hint 'struct<image:array<float>,label:int>' \\
        --input_mapping '{"image": "x"}' \\
        --output_mapping '{"out": "prediction"}' \\
        --output /data/predictions
"""

import argparse
import json
import logging
import os
import sys

from tensorflowonspark_tpu_torch import pipeline
from tensorflowonspark_tpu_torch.data import dfutil
from tensorflowonspark_tpu_torch.tools import setup_logging


def build_parser():
    p = argparse.ArgumentParser(
        description="Run batch inference over TFRecords, writing JSON"
    )
    p.add_argument("--export_dir", default=None,
                   help="export directory (tools.model_export output)")
    p.add_argument("--model_dir", default=None,
                   help="checkpoint directory (requires --model_name)")
    p.add_argument("--model_name", default=None,
                   help="registry model name for checkpoint inference")
    p.add_argument("--model_kwargs", default=None,
                   help="JSON dict of model constructor kwargs")
    p.add_argument("--input", required=True, help="TFRecord dir or file")
    p.add_argument("--schema_hint", default=None,
                   help="struct<name:type,...> schema override")
    p.add_argument("--input_mapping", default=None,
                   help="JSON {column: signature_input_alias}")
    p.add_argument("--output_mapping", default=None,
                   help="JSON {signature_output_alias: output_column}")
    p.add_argument("--signature_def_key", default=None)
    p.add_argument("--tag_set", default=None)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--cluster_size", type=int, default=1,
                   help="executor processes for data-parallel inference")
    p.add_argument("--output", required=True,
                   help="output dir for part-*.jsonl ('-' for stdout)")
    p.add_argument("--device", default="cuda",
                   help="device each executor loads the model onto "
                        "('cuda' or 'cpu')")
    return p


def main(argv=None):
    setup_logging(logging.INFO)
    args = build_parser().parse_args(argv)
    if not args.export_dir and not (args.model_dir and args.model_name):
        raise SystemExit(
            "need --export_dir, or --model_dir with --model_name"
        )

    schema_hint = (
        dfutil.parse_schema_hint(args.schema_hint) if args.schema_hint else None
    )
    table = dfutil.load_tfrecords(args.input, schema_hint=schema_hint)

    model = pipeline.TFModel()
    model.setBatchSize(args.batch_size).setClusterSize(args.cluster_size)
    model.setDevice(args.device)
    if args.export_dir:
        model.setExportDir(args.export_dir)
    else:
        model.setModelDir(args.model_dir).setModelName(args.model_name)
        if args.model_kwargs:
            model.setModelKwargs(json.loads(args.model_kwargs))
    if args.input_mapping:
        model.setInputMapping(json.loads(args.input_mapping))
    if args.output_mapping:
        model.setOutputMapping(json.loads(args.output_mapping))
    if args.signature_def_key:
        model.setSignatureDefKey(args.signature_def_key)
    if args.tag_set:
        # Same comma-separated form the export CLI writes.
        model.setTagSet([t for t in args.tag_set.split(",") if t])

    out = model.transform(table)

    if args.output == "-":
        for row in out:
            json.dump(row, sys.stdout)
            sys.stdout.write("\n")
        return
    os.makedirs(args.output, exist_ok=True)
    path = os.path.join(args.output, "part-00000.jsonl")
    with open(path, "w") as f:
        for row in out:
            json.dump(row, f)
            f.write("\n")
    print(path)


if __name__ == "__main__":
    main()
