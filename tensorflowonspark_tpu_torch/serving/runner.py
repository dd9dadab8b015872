"""The serving engine's model runner (port of ``serving/runner.py``).

Owns the paged device pool and runs the engine's device work:

* **prefill** — the prompt forward through a PRIVATE contiguous cache,
  exactly like a solo ``generate()`` batched prefill (same model code,
  same masking), in chunks of ``prefill_chunk`` tokens. Allocation is
  bucketed (power of two, floor ``prefill_floor``, up to one chunk; then
  chunk multiples).
* **scatter** — moves a finished prefill's K/V out of the private cache
  into the request's pool pages; padding positions go to the trash page. Quantizes on the way in when the pool
  is int8.
* **decode** — the continuous-batching step: ``max_slots`` rows, each at
  its own position, K/V appended into pool pages through the page table
  and the ``ops.paged_attention`` kernel walking them; per-row greedy or
  temperature sampling with optional per-row top-k/top-p filters (the
  filter semantics of ``models.decoding._sample``, vectorized per row),
  drawing from a ``torch.Generator`` on the device.

The pool layout is the JAX package's: per layer ``k_pages``/``v_pages``
``(num_pages, page_size, h_kv, d)`` in the model dtype or int8, plus
``k_scales``/``v_scales`` ``(num_pages, page_size, h_kv)`` f32 when int8.
Writes land in place (PyTorch writes pool pages without copying the
pool), so the multi-step window the JAX runner needs on XLA:CPU has no
counterpart here, and one decode call is one step (``horizon=1``).
"""

import numpy as np
import torch

from tensorflowonspark_tpu_torch.models import decoding
from tensorflowonspark_tpu_torch.models.transformer import (
    _NEG_INF, _kv_quantize,
)
from tensorflowonspark_tpu_torch.serving.cache import PagePool


def _block_keys(cfg):
    return ["block_{}".format(i) for i in range(cfg.num_layers)]


class ModelRunner:
    """Owns the paged device pool and every serving program."""

    def __init__(self, model, variables, *, max_slots, page_size,
                 num_pages, max_model_len=None, prefill_chunk=512,
                 prefill_floor=128, kv_quant="", rng_seed=0):
        decoding.load_variables(model, variables)
        cfg = model.cfg
        self.model = model
        self.device = model.device
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.kv_quant = str(kv_quant or "")
        if self.kv_quant not in ("", "int8"):
            raise ValueError("kv_quant must be '' or 'int8', got "
                             "{!r}".format(self.kv_quant))
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.prefill_floor = max(1, int(prefill_floor))
        self.max_model_len = int(min(
            max_model_len or cfg.max_seq_len, cfg.max_seq_len))
        # Enough table entries for the longest request; same rounding rule
        # as the scheduler.
        self.table_width = PagePool.pages_needed(self.max_model_len,
                                                 self.page_size)
        self.cache = self._init_paged_cache()
        self.pool_bytes = int(sum(
            t.numel() * t.element_size()
            for layer in self.cache.values() for t in layer.values()))
        self.rng = torch.Generator(device=self.device).manual_seed(
            int(rng_seed))

    # -- paged cache ---------------------------------------------------------

    def _init_paged_cache(self):
        cfg = self.model.cfg
        shape = (self.num_pages, self.page_size, cfg.kv_heads, cfg.head_dim)
        pages_dtype = torch.int8 if self.kv_quant else cfg.dtype
        cache = {}
        for key in _block_keys(cfg):
            layer = {
                "k_pages": torch.zeros(shape, dtype=pages_dtype,
                                       device=self.device),
                "v_pages": torch.zeros(shape, dtype=pages_dtype,
                                       device=self.device),
            }
            if self.kv_quant:
                # Zero scales on unwritten slots dequantize to the zeros
                # an unquantized pool starts with.
                for name in ("k_scales", "v_scales"):
                    layer[name] = torch.zeros(shape[:3], dtype=torch.float32,
                                              device=self.device)
            cache[key] = layer
        return cache

    # -- prefill -------------------------------------------------------------

    def prefill_alloc(self, prompt_len):
        """Private-cache allocation for a ``prompt_len`` prefill: the
        power-of-two bucket (floor ``prefill_floor``) while one chunk
        covers it, then chunk multiples."""
        p = int(prompt_len)
        if p > self.max_model_len:
            raise ValueError("prompt ({}) exceeds max_model_len ({})"
                             .format(p, self.max_model_len))
        if p <= self.prefill_chunk:
            alloc = self.prefill_floor
            while alloc < p:
                alloc *= 2
            return min(alloc, max(self.prefill_chunk, self.prefill_floor),
                       self.model.cfg.max_seq_len)
        return -(-p // self.prefill_chunk) * self.prefill_chunk

    def new_prefill_cache(self, alloc):
        """A fresh zeroed contiguous cache for one ``alloc``-slot prefill
        (batch of 1)."""
        return decoding.init_cache(self.model, 1, int(alloc))

    @torch.no_grad()
    def prefill_step(self, cache, tokens, last_idx, alloc):
        """Run one prompt chunk (``tokens`` (1, L)) through the private
        cache. Returns ``(cache, last_logits)``: the f32 (vocab,) logits
        at position ``last_idx`` of the chunk (the prompt's final token
        on the last chunk). ``alloc`` is the cache's allocation."""
        if cache["block_0"]["cached_key"].shape[1] != int(alloc):
            raise ValueError("prefill cache does not have allocation "
                             "{}".format(alloc))
        toks = torch.as_tensor(np.asarray(tokens, np.int32),
                               device=self.device)
        logits = self.model(toks, decode=True, cache=cache)
        return cache, logits[0, int(last_idx)].float()

    # -- scatter -------------------------------------------------------------

    @torch.no_grad()
    def scatter(self, pcache, page_row, true_len, alloc):
        """Copy cache slots ``[0, true_len)`` of a finished prefill into
        the request's pool pages (``page_row``: its page ids); padding
        slots go to the trash page. Quantizes on the way in when the pool
        is int8."""
        alloc = int(alloc)
        ps = self.page_size
        row = np.zeros((self.table_width,), np.int64)
        row[:len(page_row)] = page_row
        pos = np.arange(alloc)
        # Slots past the table (an allocation larger than max_model_len)
        # are padding; clamp their lookup, their destination is trash.
        page = row[np.minimum(pos // ps, self.table_width - 1)]
        dest = np.where(pos < int(true_len), page * ps + pos % ps, 0)
        dest = torch.as_tensor(dest, device=self.device)
        n = self.num_pages * ps
        for key, layer in self.cache.items():
            k_rows = pcache[key]["cached_key"][0]
            v_rows = pcache[key]["cached_value"][0]
            h_kv, d = k_rows.shape[1:]
            if self.kv_quant:
                k_rows, k_s = _kv_quantize(k_rows)
                v_rows, v_s = _kv_quantize(v_rows)
                layer["k_scales"].view(n, h_kv).index_put_((dest,), k_s)
                layer["v_scales"].view(n, h_kv).index_put_((dest,), v_s)
            layer["k_pages"].view(n, h_kv, d).index_put_(
                (dest,), k_rows.to(layer["k_pages"].dtype))
            layer["v_pages"].view(n, h_kv, d).index_put_(
                (dest,), v_rows.to(layer["v_pages"].dtype))

    # -- decode --------------------------------------------------------------

    @torch.no_grad()
    def decode(self, toks, table, lens, temps, top_ks, top_ps,
               sampling=True, filtered=False):
        """One continuous decode step over every slot.

        ``toks``: (max_slots,) each row's input token; ``table``:
        (max_slots, table_width) page table; ``lens``: (max_slots,) tokens
        already in each row's cache (the input token's position);
        ``temps``: per-row temperature (0 = greedy); ``top_ks``/``top_ps``:
        per-row filters (0 = off). Sampling draws from the runner's
        ``torch.Generator`` on the device, seeded from ``rng_seed``.
        Returns (max_slots, 1) int32 numpy. ``sampling=False`` skips the
        sampler (no row samples), ``filtered=False`` the per-row sort."""
        dev = self.device
        toks = torch.as_tensor(np.asarray(toks, np.int32), device=dev)
        table = torch.as_tensor(np.asarray(table, np.int32), device=dev)
        lens = torch.as_tensor(np.asarray(lens, np.int32), device=dev)
        logits = self.model(toks[:, None].long(), decode=True, pages=table,
                            seq_lens=lens, cache=self.cache)
        logits = logits[:, 0].float()
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        if not sampling:
            return greedy[:, None].cpu().numpy()
        temps = torch.as_tensor(np.asarray(temps, np.float32), device=dev)
        tks = torch.as_tensor(np.asarray(top_ks, np.int64), device=dev)
        tps = torch.as_tensor(np.asarray(top_ps, np.float32), device=dev)
        scaled = logits / torch.clamp_min(temps, 1e-6)[:, None]
        if filtered:
            scaled = _filter_rows(scaled, tks, tps)
        noise = decoding._gumbel(scaled.shape, self.rng, dev)
        sampled = torch.argmax(scaled + noise, dim=-1).to(torch.int32)
        out = torch.where(temps <= 0.0, greedy, sampled)
        return out[:, None].cpu().numpy()


def _filter_rows(scaled, tks, tps):
    """Per-row top-k / top-p filters over temperature-scaled logits: one
    descending sort serves both; rows with a filter off keep their full
    distribution."""
    vocab = scaled.shape[-1]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    has_k = (tks > 0)[:, None]
    kth = sorted_desc.gather(1, torch.clamp(tks - 1, 0, vocab - 1)[:, None])
    scaled = torch.where(has_k & (scaled < kth), _NEG_INF, scaled)
    pos = torch.arange(vocab, device=scaled.device)[None, :]
    sorted_cut = torch.where(has_k & (pos >= tks[:, None]), _NEG_INF,
                             sorted_desc)
    probs = torch.softmax(sorted_cut, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs
    keep_sorted = cum_before < tps[:, None]
    thresh = torch.where(keep_sorted, sorted_cut, torch.inf).amin(
        dim=-1, keepdim=True)
    has_p = ((tps > 0.0) & (tps < 1.0))[:, None]
    return torch.where(has_p & (scaled < thresh), _NEG_INF, scaled)
