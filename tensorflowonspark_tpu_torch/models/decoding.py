"""Autoregressive decoding (port of ``models/decoding.py``).

The SOLO path: one batch of prompts, a private contiguous KV cache, a
batched prefill (one forward writes the whole prompt's K/V; ``stepwise``
feeds it token by token) and then one token per step. It is the baseline
the continuous-batching engine (:mod:`tensorflowonspark_tpu_torch.serving`)
is held against: greedy engine streams equal this module's ``generate``
bitwise.

Sampling: greedy (``temperature=0``), temperature, top-k and top-p with
the JAX package's filter semantics; ``eos_token`` freezes finished rows at
``pad_token``. Random draws come from a ``torch.Generator``; they are not
``jax.random``'s bits, so sampled streams match the JAX package only in
distribution.

``speculative_lengths`` is the engine's greedy acceptance rule: numpy in,
numpy out, the JAX function's arithmetic.
"""

import numpy as np
import torch

from tensorflowonspark_tpu_torch.models.transformer import _NEG_INF


def _gumbel(shape, rng, device):
    u = torch.rand(shape, generator=rng, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _sample(logits, rng, temperature, top_k, top_p, noise=None):
    """One token per batch row from ``(b, vocab)`` logits. ``noise``
    (Gumbel, ``(b, vocab)``) replaces the draw from ``rng`` — the tests
    feed both frameworks the same noise."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / float(temperature)
    nucleus = bool(top_p) and top_p < 1.0
    if top_k or nucleus:
        # One descending sort serves both filters.
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        if top_k:
            kth = sorted_desc[:, int(top_k) - 1][:, None]
            logits = torch.where(logits < kth, _NEG_INF, logits)
            pos = torch.arange(sorted_desc.shape[-1],
                               device=logits.device)[None, :]
            sorted_desc = torch.where(pos < int(top_k), sorted_desc,
                                      _NEG_INF)
        if nucleus:
            # Keep the smallest prefix of descending-probability tokens
            # whose mass reaches top_p (the first token always stays).
            probs = torch.softmax(sorted_desc, dim=-1)
            cum_before = torch.cumsum(probs, dim=-1) - probs
            keep_sorted = cum_before < float(top_p)
            thresh = torch.where(keep_sorted, sorted_desc,
                                 torch.inf).amin(dim=-1, keepdim=True)
            logits = torch.where(logits < thresh, _NEG_INF, logits)
    if noise is None:
        noise = _gumbel(logits.shape, rng, logits.device)
    return torch.argmax(logits + noise, dim=-1).to(torch.int32)


def init_cache(model, batch_size, cache_len=None):
    """An empty (index-0, zeroed) contiguous KV cache for ``batch_size``
    rows on the model's device. ``cache_len`` defaults to the model's
    ``decode_cache_len`` or ``max_seq_len``."""
    cfg = model.cfg
    cache_len = int(cache_len or cfg.decode_cache_len or cfg.max_seq_len)
    shape = (int(batch_size), cache_len, cfg.kv_heads, cfg.head_dim)
    cache = {"position": 0}
    for i in range(cfg.num_layers):
        cache["block_{}".format(i)] = {
            "cached_key": torch.zeros(shape, dtype=cfg.dtype,
                                      device=model.device),
            "cached_value": torch.zeros(shape, dtype=cfg.dtype,
                                        device=model.device),
            "cache_index": 0,
        }
    return cache


def serving_variables(variables, dtype=torch.bfloat16):
    """Cast the floating-point tensors of a ``state_dict`` to the serving
    dtype ONCE (the model casts per call otherwise); other tensors pass
    through. Load the result with :func:`load_variables`."""
    return {
        name: t.to(dtype) if t.is_floating_point() else t
        for name, t in variables.items()
    }


def load_variables(model, variables):
    """Adopt ``variables`` (a ``state_dict``, e.g. from
    ``convert.params_from_flax`` or :func:`serving_variables`) as the
    model's parameters, on the model's device and in the dtypes given.
    ``None`` keeps the model's own parameters."""
    if variables is None:
        return model
    dev = model.device
    model.load_state_dict(
        {name: torch.as_tensor(t).to(dev) for name, t in variables.items()},
        assign=True)
    return model


def _bucketed_cache_len(needed, max_seq_len):
    """Power-of-two cache bucket covering ``needed`` slots (floor 128),
    capped at ``max_seq_len``."""
    bucket = 128
    while bucket < needed:
        bucket *= 2
    return min(bucket, max_seq_len)


@torch.no_grad()
def generate(model, variables, prompt, max_new_tokens, rng=None,
             temperature=0.0, top_k=0, top_p=0.0, eos_token=None,
             pad_token=None, prefill="batched", auto_cache=False):
    """Generate ``max_new_tokens`` continuations of ``prompt`` (int
    ``(batch, prompt_len)``, any array-like). Returns int32 ``(batch,
    prompt_len + max_new_tokens)`` on the model's device.

    ``variables``: a ``state_dict`` to adopt first (see
    :func:`load_variables`), or None for the model's own weights.
    ``rng``: a ``torch.Generator`` on the model's device (default: seeded
    0). ``auto_cache=True`` allocates the cache at the power-of-two bucket
    (floor 128) covering ``prompt + max_new_tokens`` — the allocation the
    engine's prefill uses, which keeps the two bitwise comparable.
    ``prefill="batched"`` runs one forward over the whole prompt to fill
    the cache; ``"stepwise"`` feeds it one token at a time (the JAX
    package's parity mode).
    """
    load_variables(model, variables)
    cfg = model.cfg
    dev = model.device
    prompt = torch.as_tensor(prompt).to(device=dev, dtype=torch.int64)
    b, p = prompt.shape
    if max_new_tokens < 0:
        raise ValueError("max_new_tokens must be >= 0")
    if p == 0:
        raise ValueError("prompt must contain at least one token")
    cache_len = cfg.decode_cache_len or cfg.max_seq_len
    if auto_cache and p + max_new_tokens <= cfg.max_seq_len:
        cache_len = _bucketed_cache_len(p + max_new_tokens, cfg.max_seq_len)
    if p + max_new_tokens > cache_len:
        raise ValueError(
            "prompt ({}) + max_new_tokens ({}) exceeds the decode cache "
            "length ({})".format(p, max_new_tokens, cache_len))
    if prefill not in ("batched", "stepwise"):
        raise ValueError("prefill must be 'batched' or 'stepwise'")
    if top_k:
        top_k = int(min(int(top_k), cfg.vocab_size))
        if top_k == cfg.vocab_size:
            top_k = 0
    if top_p and not 0.0 < top_p <= 1.0:
        raise ValueError("top_p must be in (0, 1]")
    prompt = prompt.to(torch.int32)
    if max_new_tokens == 0:
        return prompt
    if rng is None:
        rng = torch.Generator(device=dev).manual_seed(0)
    eos = -1 if eos_token is None else int(eos_token)
    pad = eos if pad_token is None else int(pad_token)

    cache = init_cache(model, b, cache_len)
    if prefill == "batched":
        last_logits = model(prompt, decode=True, cache=cache)[:, -1]
    else:
        for t in range(p):
            last_logits = model(prompt[:, t:t + 1], decode=True,
                                cache=cache)[:, 0]
    tok = _sample(last_logits, rng, temperature, top_k, top_p)
    done = tok == eos if eos >= 0 else None
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits = model(tok[:, None], decode=True, cache=cache)
        nxt = _sample(logits[:, 0], rng, temperature, top_k, top_p)
        if done is not None:
            nxt = torch.where(done, pad, nxt).to(torch.int32)
            done = done | (nxt == eos)
        out.append(nxt)
        tok = nxt
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)


def speculative_lengths(draft, greedy):
    """Greedy speculative acceptance (the JAX package's
    ``speculative_lengths``): the lossless temperature-0 case of Leviathan
    et al.'s rejection sampling, where acceptance is an exact token match.

    ``draft``: (rows, k) int, the draft's k proposals a row; ``greedy``:
    (rows, W >= k) int, the target's greedy argmax at each verify position
    (``serving.runner.ModelRunner.verify``): column j is the target's next
    token after the j-th verify input (column 0 the row's newest real
    token, columns 1..k the proposals).

    Returns ``(accepted, emitted)`` int64 (rows,) arrays: ``accepted`` is
    the longest proposal prefix the target reproduces (the first mismatch's
    index, k when all match); ``emitted`` the accepted prefix plus the
    target's correction token, capped at k. With no bonus token on full
    acceptance, draft and target caches both hold exactly the emitted
    prefix, and the k-th proposal becomes the next round's input. Every
    emitted token is ``greedy[row, :emitted]``, the target's own choice."""
    draft = np.asarray(draft)
    greedy = np.asarray(greedy)
    k = draft.shape[1]
    match = draft == greedy[:, :k]
    accepted = np.where(match.all(axis=1), k, match.argmin(axis=1))
    return accepted, np.minimum(accepted + 1, k)
