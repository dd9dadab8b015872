"""Page-pool accounting: the serving engine's cache manager.

The device-side pool (one ``(num_pages, page_size, h_kv, d)`` array per
layer per K/V, ``models.transformer``) is dumb storage; THIS ledger is
the authority on which pages belong to whom. Page 0 is reserved as the
trash page — inactive batch rows in the shared decode step write there,
so the batched decode step never branches per row — which makes the
allocatable capacity ``num_pages - 1``.

Allocation is all-or-nothing per request (the engine reserves
``ceil((prompt + max_new_tokens) / page_size)`` pages at admission, so
an admitted request can always run to completion — backpressure happens
at admission, never as a mid-flight eviction). Double-free and
foreign-free raise: a page accounting leak in a long-lived serving
process is unrecoverable, so the ledger fails loudly instead of
drifting (drilled in tests/test_serving_engine.py).

**Prefix sharing (copy-on-write).** Pages are reference-counted and the
pool keeps a *prefix index*: a chain hash of the token ids in each FULL
prompt page maps to the page holding that prefix's K/V. Admission
(:meth:`admit`) walks the new prompt's chain keys, bumps refcounts on
every matched page instead of allocating, and allocates only the
remainder — N requests on one system prompt pay its pages (and, in the
engine, its prefill) once. ``free()`` decrements; a page whose count
hits zero while still indexed is not recycled but parked in the
**cached tier** (index entry intact, evicted LRU only when a fresh
allocation outgrows the free list), so a fleet of users arriving one
after another — not just concurrently — keeps hitting the prefix; and
a sharer cancelling mid-stream can never free pages another sharer
still reads. A holder that must WRITE a page whose refcount exceeds
one (the last, partially-filled page when a whole prompt matched)
copies it first — :meth:`admit` folds the ledger half into the
reservation (fresh page in, source retained until copied), the
runner's ``copy_pages`` does the device half; :meth:`cow` is the
stand-alone ledger op. The chain key includes every preceding page's
content by construction (sha1 over the running token stream), so a
page can only match behind an identical full-page prefix.
"""

import hashlib
import threading


class CacheFull(ValueError):
    """A reservation exceeds the pool's TOTAL capacity — the request can
    never be admitted, at any occupancy (raised at submit; transient
    exhaustion is not an exception: the request just stays queued until
    pages free)."""


def prefix_keys(tokens, page_size):
    """Chain keys for every FULL ``page_size``-token page of ``tokens``
    (1-D int32 array/sequence): key j is the sha1 over pages 0..j's
    token bytes, so equal keys imply equal full-page *prefixes*, not
    just equal page contents. The index granularity is deliberately the
    full page — a partially-filled page's content is still growing and
    cannot be matched stably."""
    import numpy as np

    toks = np.ascontiguousarray(np.asarray(tokens, np.int32).reshape(-1))
    full = toks.shape[0] // int(page_size)
    h = hashlib.sha1()
    keys = []
    for j in range(full):
        h.update(toks[j * page_size:(j + 1) * page_size].tobytes())
        keys.append(h.digest())
    return keys


class PagePool:
    """Free-list allocator over ``num_pages`` fixed-size cache pages,
    with per-page refcounts and the copy-on-write prefix index.

    Thread-safe (the engine's HTTP submission threads race the step
    loop). Page 0 never leaves the trash role.
    """

    TRASH_PAGE = 0

    def __init__(self, num_pages, page_size):
        if num_pages < 2:
            raise ValueError(
                "num_pages must be >= 2 (page 0 is the trash page)")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._lock = threading.Lock()
        # Pop from the end -> ascending page ids first (deterministic
        # layouts make the equivalence tests and incident dumps legible).
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._ref = {}            # page id -> refcount (allocated pages)
        self._index = {}          # chain key -> page id (prefix index)
        self._page_keys = {}      # page id -> chain key (for dereg)
        # Cached tier: indexed pages whose last holder released them.
        # Insertion-ordered dict = LRU eviction order (re-parked pages
        # re-insert at the tail). Content stays valid on device until
        # eviction recycles the page.
        self._cached = {}
        self.cow_copies = 0       # lifetime COW page copies
        # Device bytes behind one page across every layer's K/V pool
        # (plus quantization scales when on) — the runner reports it
        # once the pool arrays exist; stats() multiplies out pool_bytes.
        self.page_bytes = 0

    @property
    def capacity(self):
        """Allocatable pages (page 0 excluded)."""
        return self.num_pages - 1

    @property
    def pages_in_use(self):
        with self._lock:
            return len(self._ref)

    @property
    def pages_free(self):
        """Allocatable pages: the free list plus the evictable cached
        tier (a cached prefix page is reclaimed the moment a fresh
        reservation needs it)."""
        with self._lock:
            return len(self._free) + len(self._cached)

    @staticmethod
    def pages_needed(tokens, page_size):
        """Pages needed to hold ``tokens`` cache slots — THE rounding
        rule; the engine's default sizing and the runner's table width
        derive from it too, so they can never diverge from what the
        scheduler actually reserves."""
        return max(1, -(-int(tokens) // int(page_size)))

    def required(self, tokens):
        """Pages needed to hold ``tokens`` cache slots."""
        return self.pages_needed(tokens, self.page_size)

    def can_allocate(self, n):
        with self._lock:
            return n <= len(self._free) + len(self._cached)

    def refcount(self, page):
        with self._lock:
            return self._ref.get(page, 0)

    def alloc(self, n):
        """Reserve ``n`` fresh pages atomically (refcount 1 each);
        returns their ids, or None when the pool cannot cover the
        reservation (the admission backpressure signal — the caller
        keeps the request queued)."""
        n = int(n)
        if n < 1:
            raise ValueError("alloc needs n >= 1")
        with self._lock:
            return self._alloc_locked(n)

    def _alloc_locked(self, n):
        if n > len(self._free) + len(self._cached):
            return None
        while len(self._free) < n:
            # Evict the least-recently-released cached prefix page:
            # drop its index entry, then recycle it. Holders are never
            # evicted (refcount >= 1 pages are not in the cached tier).
            victim = next(iter(self._cached))
            del self._cached[victim]
            key = self._page_keys.pop(victim, None)
            if key is not None:
                self._index.pop(key, None)
            self._free.append(victim)
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def admit(self, keys, n_total, prompt_len=None):
        """Atomic shared admission: match the longest registered chain
        prefix of ``keys`` (every key must extend the previous one —
        :func:`prefix_keys`' construction), RETAIN those pages, and
        allocate the ``n_total - matched`` remainder. Returns
        ``(pages, matched, cow_src)`` with the shared pages first
        (page j holds positions ``[j*page_size, (j+1)*page_size)``),
        or ``None`` when the remainder cannot be covered — in which
        case nothing was retained (all-or-nothing, same contract as
        :meth:`alloc`).

        **Copy-on-write**: when the match covers the WHOLE prompt
        (``prompt_len`` given and ``matched*page_size >= prompt_len``),
        the prompt's last token must still be re-run for its logits,
        and its K/V write would land in the last matched page — which
        other holders read. That page is demoted from the match: the
        reservation gets a fresh private page in its position instead,
        ``cow_src`` names the shared page whose content the caller must
        copy into it (``ModelRunner.copy_pages``) before reading or
        writing, and ``cow_src`` itself is RETAINED until the caller
        drops it (one extra ``free([cow_src])`` after the copy — or at
        release if the request dies first), so a concurrent release by
        its other holders can never recycle it mid-copy."""
        n_total = int(n_total)
        if n_total < 1:
            raise ValueError("admit needs n_total >= 1")
        with self._lock:
            shared = []
            for key in keys:
                page = self._index.get(key)
                if page is None or len(shared) >= n_total - 1:
                    # Cap: at least one page of the reservation must be
                    # private — decode always writes past the prompt.
                    break
                shared.append(page)
            cow_src = None
            if (prompt_len is not None and shared
                    and len(shared) * self.page_size >= int(prompt_len)):
                cow_src = shared.pop()
            own_needed = n_total - len(shared)
            # All-or-nothing check BEFORE mutating anything: the
            # allocatable supply excludes cached pages this very match
            # is about to revive.
            reserved = set(shared)
            if cow_src is not None:
                reserved.add(cow_src)
            evictable = sum(1 for p in self._cached if p not in reserved)
            if own_needed > len(self._free) + evictable:
                return None
            for p in shared:
                self._retain_locked(p)
            if cow_src is not None:
                self._retain_locked(cow_src)
                self.cow_copies += 1
            own = self._alloc_locked(own_needed)
            assert own is not None  # covered by the check above
            return shared + own, len(shared), cow_src

    def _retain_locked(self, page):
        """Take one reference on an indexed page: a cached (holder-less)
        page revives out of the LRU tier; a held page's count bumps."""
        if page in self._cached:
            del self._cached[page]
            self._ref[page] = 1
        else:
            self._ref[page] += 1

    def cow(self, page):
        """Copy-on-write, ledger half: allocate a fresh page for a
        holder about to WRITE ``page`` while others still read it
        (refcount > 1). Drops the caller's reference on ``page`` and
        returns the fresh page id (refcount 1), or None when the pool
        has no free page — the caller must treat that as it treats any
        failed reservation. The device copy is the runner's
        ``copy_pages``. Raises if the caller holds no reference."""
        with self._lock:
            ref = self._ref.get(page)
            if ref is None:
                raise RuntimeError(
                    "cow on page {} which is not allocated".format(page))
            if ref < 2:
                raise RuntimeError(
                    "cow on page {} with refcount {} — an exclusive "
                    "holder writes in place".format(page, ref))
            fresh = self._alloc_locked(1)
            if fresh is None:
                return None
            self._ref[page] = ref - 1
            self.cow_copies += 1
            return fresh[0]

    def index_match_len(self, keys):
        """Longest leading run of ``keys`` present in the prefix index —
        the fleet router's affinity probe (how many full prompt pages
        THIS pool already holds), read-only and cheap: no refcounts
        move, so a routing decision never pins pages it may not use."""
        with self._lock:
            n = 0
            for key in keys:
                if key not in self._index:
                    break
                n += 1
            return n

    def index_digest(self, limit=512, width=8):
        """Compact digest of the prefix index for heartbeat transport:
        truncated hex prefixes of the resident chain keys,
        insertion-ordered (newest last), capped at the ``limit`` newest
        entries. ``node_stats()`` ships it as ``serve_prefix_digest``
        so a fleet router can affinity-probe REMOTE pools
        (``fleet.RemoteEngine.match_tokens``) without a round trip. A
        truncated-key collision can only mis-rank a route — admission
        on the owning engine matches full keys, so correctness never
        rides the digest."""
        with self._lock:
            keys = list(self._index)
        if len(keys) > int(limit):
            keys = keys[-int(limit):]
        return [k[:int(width)].hex() for k in keys]

    def register_prefix(self, key, page):
        """Publish ``page`` (holding one full prompt page whose chain
        key is ``key``) in the prefix index. First writer wins: an
        existing entry is kept — the racing request simply keeps its
        private copy unshared. Entries dereg automatically when their
        page's refcount hits zero. Returns True when the entry was
        installed."""
        with self._lock:
            if page not in self._ref:
                raise RuntimeError(
                    "register_prefix on page {} which is not "
                    "allocated".format(page))
            if key in self._index or page in self._page_keys:
                return False
            self._index[key] = page
            self._page_keys[page] = key
            return True

    def free(self, pages):
        """Drop one reference per page. At refcount zero an INDEXED page
        parks in the cached tier (content and index entry intact — the
        next identical prefix revives it; eviction reclaims it only
        under allocation pressure); an unindexed page returns straight
        to the free list. Raises on double-free or a page the pool
        never handed out — accounting leaks must be loud."""
        with self._lock:
            counts = {}
            for p in pages:
                counts[p] = counts.get(p, 0) + 1
            for p, n in counts.items():
                # Validate BEFORE mutating (a partial decrement on a bad
                # batch would corrupt the ledger): the drop must be
                # covered by outstanding references — this also keeps a
                # page listed TWICE in one call loud when only one
                # reference exists, instead of a late KeyError.
                if self._ref.get(p, 0) < n:
                    raise RuntimeError(
                        "page {} freed {}x but has {} reference(s) "
                        "(double free or foreign page)".format(
                            p, n, self._ref.get(p, 0)))
            for p in pages:
                self._ref[p] -= 1
                if self._ref[p] == 0:
                    del self._ref[p]
                    if p in self._page_keys:
                        self._cached[p] = None   # LRU tail
                    else:
                        self._free.append(p)

    def purge_index(self):
        """Drop the whole prefix index and recycle the cached tier —
        the engine calls this after rebuilding a failed pool (the
        device arrays were zeroed, so every indexed page's content is
        gone; matching against it would serve garbage prefixes)."""
        with self._lock:
            self._free.extend(self._cached)
            self._cached.clear()
            self._index.clear()
            self._page_keys.clear()

    def stats(self):
        with self._lock:
            refs = self._ref.values()
            return {
                "num_pages": self.num_pages,
                "page_size": self.page_size,
                "capacity": self.num_pages - 1,
                "in_use": len(self._ref),
                "free": len(self._free) + len(self._cached),
                "cached_pages": len(self._cached),
                # Sharing efficiency: pages held by more than
                # one request, total references outstanding (in_use +
                # the sharing surplus), lifetime COW copies, and the
                # device bytes behind the whole pool (page_bytes is
                # reported by the runner once the arrays exist — it
                # reflects the KV dtype, scales included).
                "shared_pages": sum(1 for r in refs if r > 1),
                "refcount_total": sum(self._ref.values()),
                "cow_copies_total": self.cow_copies,
                "indexed_prefix_pages": len(self._index),
                "pool_bytes": self.page_bytes * self.num_pages,
            }
