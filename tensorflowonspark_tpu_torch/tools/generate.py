"""LM generation CLI: prompts in, continuations out (port of
``tools/generate.py``).

The serving-side companion of :mod:`tensorflowonspark_tpu_torch.tools.
inference` for autoregressive models: load an export (registry rebuild) or
a training checkpoint onto ``--device`` (the card by default) and decode
continuations of token-id prompts with ``models.decoding.generate``.

Usage::

    python -m tensorflowonspark_tpu_torch.tools.generate \\
        --export_dir /exports/lm --prompt "5 6 7" --max_new_tokens 32

    python -m tensorflowonspark_tpu_torch.tools.generate \\
        --model_dir /ckpts/lm --model_name transformer \\
        --model_kwargs '{"vocab_size": 512, ...}' \\
        --prompts_file prompts.txt --output out.jsonl \\
        --temperature 0.8 --top_k 40

Prompts are whitespace-separated token ids, one prompt per line. Output:
one JSON object per prompt with ``prompt`` and ``tokens`` (the full
sequence including the prompt). Sampling draws from a ``torch.Generator``
seeded per prompt from ``(--seed, prompt index)``, so a prompt's stream does
not depend on the prompts before it; the draws are not ``jax.random``'s, so
sampled streams match the JAX CLI only in distribution (greedy ones
exactly).
"""

import argparse
import dataclasses
import json
import logging
import sys

import numpy as np

from tensorflowonspark_tpu_torch import export as export_lib
from tensorflowonspark_tpu_torch.tools import setup_logging


def build_parser():
    p = argparse.ArgumentParser(
        description="Generate LM continuations via KV-cache decoding"
    )
    p.add_argument("--export_dir", default=None,
                   help="export directory (registry rebuild; AOT-only "
                        "exports cannot decode)")
    p.add_argument("--model_dir", default=None,
                   help="training checkpoint directory")
    p.add_argument("--model_name", default=None,
                   help="registry model name (required with --model_dir)")
    p.add_argument("--model_kwargs", default=None,
                   help="JSON dict of model constructor kwargs")
    p.add_argument("--prompt", default=None,
                   help="one prompt: whitespace-separated token ids")
    p.add_argument("--prompts_file", default=None,
                   help="file of prompts, one per line")
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--auto_cache", action="store_true",
                   help="right-size the KV cache per request (power-of-2 "
                        "buckets, floor 128): short serves on long-max "
                        "models allocate and walk the short cache")
    p.add_argument("--chunked_cache", action="store_true",
                   help="decode attention walks the KV cache in 128-slot "
                        "chunks up to the valid prefix, so per-step cost "
                        "tracks the conversation's length, not the "
                        "allocation (composes with --auto_cache)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy")
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=0.0,
                   help="nucleus sampling mass in (0, 1]; 0 disables")
    p.add_argument("--eos_token", type=int, default=None,
                   help="stop token: rows that emit it produce pad_token "
                        "afterwards")
    p.add_argument("--pad_token", type=int, default=None,
                   help="filler after EOS (default: eos_token)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output", default=None,
                   help="JSONL output path (default: stdout)")
    p.add_argument("--device", default="cuda",
                   help="device to decode on ('cuda' or 'cpu')")
    return p


def with_decode_attention(model, decode_attention):
    """Rebind ``model``'s config (in every module that holds it) to
    ``decode_attention``: a config change of the decode path alone, so the
    parameters are untouched (the JAX CLI's ``model.clone(cfg=...)``)."""
    old = model.cfg
    new = dataclasses.replace(old, decode_attention=decode_attention)
    for module in model.modules():
        if module.__dict__.get("cfg") is old:
            module.cfg = new
    return model


def prompt_generator(seed, index, device):
    """The ``torch.Generator`` of prompt ``index``: seeded from ``(seed,
    index)``, the counterpart of ``jax.random.fold_in(PRNGKey(seed),
    index)``."""
    import torch

    state = np.random.SeedSequence([int(seed), int(index)])
    return torch.Generator(device=device).manual_seed(
        int(state.generate_state(1, dtype=np.uint64)[0] >> 1))


def main(argv=None):
    setup_logging(logging.INFO)
    parser = build_parser()
    args = parser.parse_args(argv)
    if not args.export_dir and not (args.model_dir and args.model_name):
        parser.error("need --export_dir, or --model_dir with --model_name")
    if not args.prompt and not args.prompts_file:
        parser.error("need --prompt or --prompts_file")

    model_kwargs = json.loads(args.model_kwargs) if args.model_kwargs else None
    if args.export_dir:
        loaded = export_lib.load_saved_model(
            args.export_dir, prefer_aot=False, device=args.device)
    else:
        loaded = export_lib.load_from_checkpoint(
            args.model_dir, args.model_name, model_kwargs=model_kwargs,
            device=args.device)

    if args.chunked_cache:
        with_decode_attention(loaded.model, "chunked")

    if args.prompts_file:
        with open(args.prompts_file) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
    else:
        lines = [args.prompt]
    prompts = [[int(t) for t in ln.split()] for ln in lines]

    out_f = open(args.output, "w") if args.output else sys.stdout
    try:
        for i, prompt in enumerate(prompts):
            tokens = loaded.generate(
                [prompt], args.max_new_tokens,
                rng=prompt_generator(args.seed, i, loaded.device),
                temperature=args.temperature, top_k=args.top_k,
                top_p=args.top_p, eos_token=args.eos_token,
                pad_token=args.pad_token, auto_cache=args.auto_cache,
            )
            out_f.write(json.dumps({
                "prompt": prompt,
                "tokens": [int(t) for t in tokens[0].tolist()],
            }) + "\n")
    finally:
        if args.output:
            out_f.close()


if __name__ == "__main__":
    main()
