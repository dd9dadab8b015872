"""Decoded-batch cache: spill epoch 1, replay epochs 2+ at reader speed
(the port's copy of the JAX package's ``data/batch_cache.py``; the file
format is the same).

JPEG decode + augmentation dominates the FILES-mode ingest cost. For
multi-epoch training the work is also *repeated*: every
epoch re-decodes the same records. ``InputPipeline(cache_dir=...)``
writes each finished (decoded, transformed, padded) batch through a
:class:`BatchCacheWriter` during the first epoch and replays later
epochs from the cache file — decode is skipped entirely and the epoch
streams at sequential-read speed.

Layout — one flat columnar container per pipeline shard:

* ``<dir>/<tag>.batches`` — concatenated batches; per batch a one-line
  JSON header (``{"n": <ncols>, "cols": [names]}``) followed by one
  ``np.lib.format`` array per column. Numeric columns round-trip with
  zero parsing; ``object`` columns (raw bytes) use the pickled array
  format.
* ``<dir>/<tag>.json`` — the manifest, written **last** and atomically
  (tmp + rename): batch count, record count, and the config fingerprint
  (file list + sizes + mtimes, batch size, column spec, pad/drop flags,
  ``cache_tag`` for the transform). A missing or mismatching manifest
  means the cache is torn or stale and is silently rebuilt.

The augmentation caveat (same as ``tf.data``'s ``cache()``): cached
batches are post-transform, so epochs 2+ replay epoch 1's augmentations
instead of redrawing them. Cache when ingest is the wall and the epoch
count is small-to-moderate; skip it when per-epoch augmentation
diversity matters more than ingest speed.
"""

import hashlib
import json
import logging
import os

import numpy as np

from tensorflowonspark_tpu_torch import telemetry

logger = logging.getLogger(__name__)

FORMAT_VERSION = 1


def config_digest(files, batch_size, columns, pad_final, drop_remainder,
                  cache_tag="", extra=None):
    """Fingerprint of everything that determines a cached batch stream —
    source files (path + size + mtime), batching geometry, column spec,
    the caller-supplied ``cache_tag`` naming the transform (a Python
    callable cannot be fingerprinted; changing the transform without
    changing the tag replays stale batches), and any
    ``extra`` stream-shaping config (InputPipeline passes its
    seed/shuffle settings, so a reseeded run rebuilds instead of
    silently replaying the old stream's composition)."""
    h = hashlib.sha256()
    h.update(json.dumps({
        "version": FORMAT_VERSION,
        "batch_size": int(batch_size),
        "columns": sorted((str(k), list(v)) for k, v in columns.items()),
        "pad_final": bool(pad_final),
        "drop_remainder": bool(drop_remainder),
        "cache_tag": str(cache_tag),
        "extra": extra,
    }, sort_keys=True, default=str).encode())
    for path in files:
        try:
            st = os.stat(path)
            # mtime at nanosecond resolution: a shard rewritten at the
            # same size within one second (regenerated synthetic data)
            # must still invalidate the cache.
            h.update("{}:{}:{}".format(path, st.st_size,
                                       st.st_mtime_ns).encode())
        except OSError:
            h.update("{}:missing".format(path).encode())
    return h.hexdigest()[:24]


class BatchCacheWriter:
    """Append-only writer; ``finalize()`` publishes atomically.

    Writes to ``<tag>.batches.tmp-<pid>`` and renames into place only
    when the epoch completed — an aborted epoch (close() mid-stream,
    producer exception) leaves no manifest, so the next run rebuilds."""

    def __init__(self, cache_dir, digest, tag="cache"):
        self.cache_dir = os.fspath(cache_dir)
        self.digest = digest
        self.tag = tag
        os.makedirs(self.cache_dir, exist_ok=True)
        self._tmp = os.path.join(
            self.cache_dir, "{}.batches.tmp-{}".format(tag, os.getpid()))
        self._f = open(self._tmp, "wb", buffering=1 << 20)
        self.batches = 0
        self.records = 0
        self.offsets = []
        self._aborted = False

    def append(self, batch):
        # Byte offset recorded per batch (into the manifest) so a
        # permuted replay can seek directly instead of re-parsing the
        # whole file to rebuild an index.
        self.offsets.append(self._f.tell())
        cols = sorted(batch.keys())
        header = json.dumps({"n": len(cols), "cols": cols})
        self._f.write((header + "\n").encode())
        for name in cols:
            arr = np.asarray(batch[name])
            np.lib.format.write_array(self._f, arr, allow_pickle=True)
        self.batches += 1
        mask = batch.get("mask")
        first = batch[cols[0]]
        self.records += int(np.sum(mask)) if mask is not None else len(first)

    def abort(self):
        """Drop the partial cache (epoch did not complete)."""
        self._aborted = True
        try:
            self._f.close()
        finally:
            try:
                os.unlink(self._tmp)
            except OSError:
                pass

    def finalize(self):
        """Publish: rename the data file, then write the manifest last
        (the manifest's existence IS the commit marker)."""
        if self._aborted:
            return None
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        final = os.path.join(self.cache_dir, self.tag + ".batches")
        os.replace(self._tmp, final)
        manifest = {
            "version": FORMAT_VERSION,
            "digest": self.digest,
            "batches": self.batches,
            "records": self.records,
            "bytes": os.path.getsize(final),
            "offsets": self.offsets,
        }
        mpath = os.path.join(self.cache_dir, self.tag + ".json")
        tmp = mpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, mpath)
        telemetry.record_span(
            "ingest/cache_write", 0.0, batches=self.batches,
            records=self.records, bytes=manifest["bytes"])
        logger.info("batch cache finalized: %d batches / %d records "
                    "(%.1f MB) at %s", self.batches, self.records,
                    manifest["bytes"] / 1e6, final)
        return manifest


def load_manifest(cache_dir, digest, tag="cache"):
    """The committed manifest matching ``digest``, or None (absent, torn,
    or recorded under a different config/source fingerprint)."""
    mpath = os.path.join(os.fspath(cache_dir), tag + ".json")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    if manifest.get("digest") != digest or \
            manifest.get("version") != FORMAT_VERSION:
        return None
    data = os.path.join(os.fspath(cache_dir), tag + ".batches")
    if not os.path.exists(data) or \
            os.path.getsize(data) != manifest.get("bytes"):
        return None
    return manifest


class BatchCacheReader:
    """Sequential replay of a committed cache file.

    ``read_batch(offset)``-free by design: replay is a forward scan
    (``iter_batches``), optionally over a permuted batch order via the
    in-memory offset index built on first full scan."""

    def __init__(self, cache_dir, manifest, tag="cache"):
        self.path = os.path.join(os.fspath(cache_dir), tag + ".batches")
        self.manifest = manifest
        self._offsets = None  # batch byte offsets, built lazily

    def _read_one(self, f):
        header = f.readline()
        if not header:
            return None
        meta = json.loads(header)
        return {
            name: np.lib.format.read_array(f, allow_pickle=True)
            for name in meta["cols"]
        }

    def iter_batches(self, order=None):
        """Yield batches in file order, or in ``order`` (a permutation of
        ``range(batches)``) using the byte-offset index."""
        if order is None:
            with open(self.path, "rb", buffering=1 << 20) as f:
                while True:
                    batch = self._read_one(f)
                    if batch is None:
                        return
                    yield batch
            return
        offsets = self._index()
        with open(self.path, "rb", buffering=1 << 20) as f:
            for b in order:
                f.seek(offsets[b])
                yield self._read_one(f)

    def _index(self):
        if self._offsets is None:
            # The writer records offsets in the manifest; the full-parse
            # scan is only the fallback for manifests written before the
            # field existed.
            recorded = self.manifest.get("offsets")
            if recorded and len(recorded) == self.manifest.get("batches"):
                self._offsets = [int(o) for o in recorded]
                return self._offsets
            offsets = []
            with open(self.path, "rb", buffering=1 << 20) as f:
                while True:
                    pos = f.tell()
                    if self._read_one(f) is None:
                        break
                    offsets.append(pos)
            self._offsets = offsets
        return self._offsets
