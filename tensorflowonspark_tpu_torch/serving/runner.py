"""The serving engine's model runner (port of ``serving/runner.py``).

Owns the paged device pool and runs the engine's device work:

* **prefill** — the prompt forward through a PRIVATE contiguous cache,
  exactly like a solo ``generate()`` batched prefill (same model code,
  same masking), in chunks of ``prefill_chunk`` tokens. Allocation is
  bucketed (power of two, floor ``prefill_floor``, up to one chunk; then
  chunk multiples).
* **gather** — the prefix-sharing inverse of scatter: fills a fresh
  private prefill cache from the pool pages a request RETAINED at
  admission (dequantizing an int8 pool) and advances its index to the
  shared extent, so the tail chunks prefill against it as a chunked
  prefill resumes against its own earlier chunks.
* **scatter** — moves a finished prefill's K/V out of the private cache
  into the request's pool pages; positions below ``start`` (the shared
  prefix, already pool-resident) and padding positions go to the trash
  page. Quantizes on the way in when the pool is int8.
* **copy** — the device half of copy-on-write: duplicates whole pages
  (values and scales); the ledger half is ``PagePool.admit``/``cow``.
* **extract / restore** — the swap half of preemption: whole pages (int8
  bytes and scales included) to host memory and back, byte for byte; the
  same host copy is what a drain migration and a disaggregated handoff
  carry to another engine (:func:`encode_handoff`/:func:`decode_handoff`,
  the JAX package's wire layout).
* **decode** — the continuous-batching step: ``max_slots`` rows, each at
  its own position, K/V appended into pool pages through the page table
  and the ``ops.paged_attention`` kernel walking them; per-row greedy or
  temperature sampling with optional per-row top-k/top-p filters (the
  filter semantics of ``models.decoding._sample``, vectorized per row),
  drawing from a ``torch.Generator`` on the device. ``horizon`` steps run
  in one call with one host sync at its end.
* **verify** — the speculative round's single target forward: W = k + 1
  tokens a row (the pending input and the draft's k proposals) through the
  paged pool, every token's K/V written at ``lens .. lens + W - 1``, the
  kernel run once over the ``max_slots x W`` query rows
  (``ops.paged_attention.paged_attention_window``); the greedy argmax at
  every position comes back in one host sync.

The pool layout is the JAX package's: per layer ``k_pages``/``v_pages``
``(num_pages, page_size, h_kv, d)`` in the model dtype or int8, plus
``k_scales``/``v_scales`` ``(num_pages, page_size, h_kv)`` f32 when int8.
Writes land in place (PyTorch writes pool pages without copying the
pool), so a horizon of k is k single-token steps, each writing its token
into the pool before the kernel reads it: the deferred-write window the
JAX runner needs (XLA cannot scatter in place) has no counterpart here,
and the paged kernel stays the only paged-attention route.
"""

import json
import struct

import numpy as np
import torch

from tensorflowonspark_tpu_torch.models import decoding
from tensorflowonspark_tpu_torch.models.transformer import (
    _NEG_INF, _kv_dequantize, _kv_quantize,
)
from tensorflowonspark_tpu_torch.serving.cache import PagePool


def _block_keys(cfg):
    return ["block_{}".format(i) for i in range(cfg.num_layers)]


class ModelRunner:
    """Owns the paged device pool and every serving program."""

    def __init__(self, model, variables, *, max_slots, page_size,
                 num_pages, max_model_len=None, prefill_chunk=512,
                 prefill_floor=128, extra_table_tokens=0, kv_quant="",
                 rng_seed=0):
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
        # Enough table entries for the longest request PLUS the engine's
        # reservation slack (a max-length request holds ceil((max_model_len
        # + horizon - 1) / page_size) pages, each in its table row); same
        # rounding rule as the scheduler.
        self.table_width = PagePool.pages_needed(
            self.max_model_len + int(extra_table_tokens), self.page_size)
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

    # -- gather (prefix sharing) ---------------------------------------------

    def _slot_ids(self, page_row, alloc):
        """Flat pool slot of each private-cache position ``[0, alloc)`` of
        a request whose pages are ``page_row``; positions past the table
        (an allocation larger than max_model_len) clamp to its last
        entry — the callers mask or trash them."""
        ps = self.page_size
        row = np.zeros((self.table_width,), np.int64)
        row[:len(page_row)] = page_row
        pos = np.arange(int(alloc))
        return row[np.minimum(pos // ps, self.table_width - 1)] * ps + pos % ps

    @torch.no_grad()
    def gather_prefix(self, page_row, extent, alloc):
        """A private prefill cache whose first ``extent`` slots hold the
        pool-resident K/V of the request's RETAINED prefix pages, with its
        index and position advanced to ``extent`` — the tail chunks then
        run against it exactly as a chunked prefill resumes against its
        own earlier chunks (the shared prefix's prefill never runs).
        Dequantizes when the pool is int8, so the tail reads the values
        the decode walk would."""
        extent = int(extent)
        pcache = self.new_prefill_cache(alloc)
        src = torch.as_tensor(self._slot_ids(page_row, alloc)[:extent],
                              device=self.device)
        n = self.num_pages * self.page_size
        for key, layer in self.cache.items():
            for name, dst in (("k", "cached_key"), ("v", "cached_value")):
                pages = layer[name + "_pages"]
                rows = pages.view((n,) + pages.shape[2:]).index_select(0, src)
                scales = layer.get(name + "_scales")
                out = pcache[key][dst]
                if scales is not None:
                    rows = _kv_dequantize(
                        rows, scales.view(n, -1).index_select(0, src),
                        out.dtype)
                out[0, :extent] = rows.to(out.dtype)
            pcache[key]["cache_index"] = extent
        pcache["position"] = extent
        return pcache

    # -- scatter -------------------------------------------------------------

    @torch.no_grad()
    def scatter(self, pcache, page_row, true_len, alloc, start=0):
        """Copy cache slots ``[start, true_len)`` of a finished prefill
        into the request's pool pages (``page_row``: its page ids);
        positions below ``start`` (the shared prefix — those pages are
        other holders' too and already hold the K/V) and padding slots go
        to the trash page. Quantizes on the way in when the pool is
        int8."""
        pos = np.arange(int(alloc))
        dest = np.where((pos >= int(start)) & (pos < int(true_len)),
                        self._slot_ids(page_row, alloc), 0)
        dest = torch.as_tensor(dest, device=self.device)
        n = self.num_pages * self.page_size
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

    # -- copy-on-write and swap ----------------------------------------------

    def _page_index(self, pages):
        return torch.as_tensor(np.asarray(pages, np.int64),
                               device=self.device)

    @torch.no_grad()
    def copy_pages(self, src_pages, dst_pages):
        """Duplicate whole pool pages (values AND scales) — the device
        half of copy-on-write: the ledger has already given the writer a
        fresh page; this fills it with the shared page's content so the
        writer's partial-page scatter lands on a private copy."""
        if len(src_pages) != len(dst_pages):
            raise ValueError("src/dst page lists must match")
        if not src_pages:
            return
        src, dst = self._page_index(src_pages), self._page_index(dst_pages)
        for layer in self.cache.values():
            for t in layer.values():
                t.index_copy_(0, dst, t.index_select(0, src))

    @torch.no_grad()
    def extract_pages(self, pages):
        """Host copy of whole pool pages — the swap-out half of
        preemption: the victim's cached K/V (int8 bytes AND scales when
        the pool is quantized) leave the device so its pages can serve a
        higher-priority request; :meth:`restore_pages` writes the exact
        bytes back at re-admission, which is why a swapped-and-resumed
        greedy stream is bitwise the uninterrupted one. Returns ``{layer:
        {pool key: (n, ...) CPU tensor}}``. Read-only on the pool."""
        if not pages:
            return {}
        idx = self._page_index(pages)
        return {key: {name: t.index_select(0, idx).cpu()
                      for name, t in layer.items()}
                for key, layer in self.cache.items()}

    @torch.no_grad()
    def restore_pages(self, host_tree, pages):
        """Swap-in: write an :meth:`extract_pages` copy into (freshly
        allocated, private) pool pages — values and scales land byte for
        byte as extracted, at the new page ids."""
        if not pages:
            return
        idx = self._page_index(pages)
        n = len(pages)
        for key, layer in self.cache.items():
            for name, t in host_tree[key].items():
                # A tree may carry padding rows past the page count (the
                # JAX extract pads to a power of two): only the first n
                # rows are pages.
                layer[name].index_copy_(0, idx, t[:n].to(self.device))

    # -- decode --------------------------------------------------------------

    @torch.no_grad()
    def decode(self, toks, table, lens, temps, top_ks, top_ps, horizon=1,
               sampling=True, filtered=False):
        """``horizon`` continuous decode steps over every slot, in one
        call.

        ``toks``: (max_slots,) each row's input token; ``table``:
        (max_slots, table_width) page table; ``lens``: (max_slots,) tokens
        already in each row's cache (the input token's position);
        ``temps``: per-row temperature (0 = greedy); ``top_ks``/``top_ps``:
        per-row filters (0 = off). Step j feeds each row the token step
        j - 1 produced at position ``lens + j`` — both stay on the device —
        so every step writes its token's K/V into the pool before the
        kernel reads it. Sampling draws from the runner's
        ``torch.Generator`` on the device, one draw a step, as ``horizon``
        calls of one step would. Returns (max_slots, horizon) int32 numpy:
        the host syncs once, at the end. The caller must ensure every
        active row's reservation covers ``horizon - 1`` tokens past its
        budget (inactive rows write the trash page). ``sampling=False``
        skips the sampler (no row samples), ``filtered=False`` the per-row
        sort."""
        dev = self.device
        tok = torch.as_tensor(np.asarray(toks, np.int32), device=dev)
        table = torch.as_tensor(np.asarray(table, np.int32), device=dev)
        lens = torch.as_tensor(np.asarray(lens, np.int32), device=dev)
        if sampling:
            temps = torch.as_tensor(np.asarray(temps, np.float32),
                                    device=dev)
            tks = torch.as_tensor(np.asarray(top_ks, np.int64), device=dev)
            tps = torch.as_tensor(np.asarray(top_ps, np.float32),
                                  device=dev)
        out = []
        for _ in range(int(horizon)):
            logits = self.model(tok[:, None].long(), decode=True,
                                pages=table, seq_lens=lens,
                                cache=self.cache)
            logits = logits[:, 0].float()
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            if sampling:
                scaled = logits / torch.clamp_min(temps, 1e-6)[:, None]
                if filtered:
                    scaled = _filter_rows(scaled, tks, tps)
                noise = decoding._gumbel(scaled.shape, self.rng, dev)
                sampled = torch.argmax(scaled + noise, dim=-1).to(
                    torch.int32)
                tok = torch.where(temps <= 0.0, tok, sampled)
            out.append(tok)
            lens = lens + 1
        return torch.stack(out, dim=1).cpu().numpy()

    # -- speculative verify --------------------------------------------------

    @torch.no_grad()
    def verify(self, toks, table, lens):
        """Teacher-forced multi-token verify, the speculative round's one
        batched target forward (the JAX runner's ``verify``).

        ``toks``: (max_slots, W) int, column 0 each row's newest token (at
        position ``lens[r]``, its K/V not yet pooled, as a decode step's
        input), columns 1..W-1 the draft's proposals. One forward writes
        every token's K/V into the row's pages at ``lens[r] .. lens[r] + W
        - 1`` before the kernel reads them, then attends each position
        over its causal prefix. Returns (max_slots, W) int32 numpy, the
        greedy argmax of the f32 logits at every position, after one host
        sync. The writes are in place, so there is no window to flush;
        rejected tokens stay in the pages as junk the lengths never expose
        (the caller's extent rollback), which the next round overwrites.
        The caller must ensure every active row's reservation covers ``W -
        1`` tokens past its budget (the engine's speculative slack)."""
        dev = self.device
        toks = torch.as_tensor(np.asarray(toks, np.int32), device=dev)
        table = torch.as_tensor(np.asarray(table, np.int32), device=dev)
        lens = torch.as_tensor(np.asarray(lens, np.int32), device=dev)
        logits = self.model(toks.long(), decode=True, pages=table,
                            seq_lens=lens, cache=self.cache, verify=True)
        greedy = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        return greedy.cpu().numpy()


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


# -- the handoff wire codec ---------------------------------------------------
#
# One request's KV pages cross between engines — a disaggregated prefill
# engine's handoff to a decode engine (``POST /v1/migrate`` or in process)
# — as one binary blob, in the JAX package's layout: a little-endian uint32
# header length, a JSON header ``{"meta": <request metadata>, "arrays":
# [{"path", "dtype", "shape"}, ...]}`` written with ``separators=(",",
# ":")``, then each leaf's raw bytes in header order. The tree is walked
# with SORTED keys at every level, so the byte layout is a function of the
# tree's shape alone, and decode(encode(x)) is byte-identical to x (int8
# page bytes and f32 scale planes included), which keeps a handed-off
# greedy stream bitwise equal to the colocated one. dtypes carry numpy's
# names, ``"bfloat16"`` included; bf16 leaves travel through a 2-byte
# integer view (numpy has no bfloat16), so no extension-dtype package is
# needed on either side.

HANDOFF_WIRE_VERSION = 1

_TORCH_NAMES = {torch.float32: "float32", torch.float16: "float16",
                torch.bfloat16: "bfloat16", torch.float64: "float64",
                torch.int8: "int8", torch.uint8: "uint8",
                torch.int16: "int16", torch.int32: "int32",
                torch.int64: "int64", torch.bool: "bool"}


def _walk_tree(tree, path=()):
    """Deterministic (sorted-key) DFS over a host page tree, yielding
    ``(dotted path, leaf)`` pairs."""
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _walk_tree(val, path + (str(key),))
        else:
            yield ".".join(path + (str(key),)), val


def _leaf_wire(leaf):
    """``(dtype name, shape, raw bytes)`` of a torch tensor or a numpy
    array (a JAX extract's leaves; a bfloat16 numpy array names itself
    ``"bfloat16"`` and its bytes are taken as they are)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = _TORCH_NAMES.get(t.dtype)
        if name is None:
            raise ValueError("no wire name for dtype {}".format(t.dtype))
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, list(t.shape), t.numpy().tobytes()
    arr = np.ascontiguousarray(np.asarray(leaf))
    return str(arr.dtype), list(arr.shape), arr.tobytes()


def encode_handoff(meta, tree):
    """Serialize a handoff: request ``meta`` (a JSON-able dict) plus a
    :meth:`ModelRunner.extract_pages` host tree into one blob."""
    arrays = []
    blobs = []
    for path, leaf in _walk_tree(tree):
        name, shape, raw = _leaf_wire(leaf)
        arrays.append({"path": path, "dtype": name, "shape": shape})
        blobs.append(raw)
    header = json.dumps({"meta": meta, "arrays": arrays},
                        separators=(",", ":")).encode("utf-8")
    return b"".join([struct.pack("<I", len(header)), header] + blobs)


def _leaf_from_wire(raw, name, shape):
    """A CPU tensor holding ``raw`` (a bytes slice) as ``name``/``shape``;
    bf16 through its 2-byte integer view."""
    if name == "bfloat16":
        arr = np.frombuffer(raw, dtype=np.int16).reshape(shape).copy()
        return torch.from_numpy(arr).view(torch.bfloat16)
    arr = np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape).copy()
    return torch.from_numpy(arr)


def _wire_itemsize(name):
    if name == "bfloat16":
        return 2
    try:
        return np.dtype(name).itemsize
    except TypeError:
        raise ValueError("unknown handoff dtype {!r}".format(name))


def decode_handoff(data):
    """Byte-exact inverse of :func:`encode_handoff`: ``(meta, tree)`` with
    every leaf a CPU tensor whose dtype, shape and bytes are exactly the
    sender's. Raises ValueError on a truncated or malformed payload."""
    view = memoryview(data)
    if len(view) < 4:
        raise ValueError("truncated handoff payload (no header length)")
    (hlen,) = struct.unpack("<I", view[:4])
    if 4 + hlen > len(view):
        raise ValueError("truncated handoff header")
    try:
        doc = json.loads(bytes(view[4:4 + hlen]).decode("utf-8"))
    except ValueError as e:
        raise ValueError("malformed handoff header: {}".format(e))
    if not isinstance(doc, dict) or "meta" not in doc \
            or not isinstance(doc.get("arrays"), list):
        raise ValueError("malformed handoff header: missing meta/arrays")
    tree = {}
    off = 4 + hlen
    for spec in doc["arrays"]:
        name = str(spec["dtype"])
        shape = tuple(int(d) for d in spec["shape"])
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nbytes = _wire_itemsize(name) * count
        if off + nbytes > len(view):
            raise ValueError("truncated handoff arrays")
        leaf = _leaf_from_wire(view[off:off + nbytes], name, shape)
        off += nbytes
        node = tree
        parts = str(spec["path"]).split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    if off != len(view):
        raise ValueError("trailing bytes in handoff payload")
    return doc["meta"], tree
