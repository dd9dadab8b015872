"""Sequence packing: variable-length documents -> fixed batches (the port's
copy of the JAX package's ``data/packing.py``; the batches are equal).

The attention stack consumes packed rows — int32 ``segment_ids`` where
0 marks padding and equal nonzero values mark one document
(``ops/attention.py``; every route, dense through the flash kernels
B1-B3, masks across segment boundaries). This module PRODUCES that
layout: a step wants fixed ``(rows, seq_len)`` shapes, and padding-only
rows waste the card's work — packing several documents per row is the
standard recipe. The reference has no analog (its pipelines were
image/tabular; SURVEY §5.7 lists long-context/packing as
reference-absent capability).

Greedy, order-preserving first-fit: a document goes into the current
row if it fits, else the row is flushed. Documents longer than
``seq_len`` are handled per ``oversize``:

* ``"split"`` (default) — chunk into seq_len pieces, each its own
  document (chunks do not attend to each other; the standard LM
  pretraining treatment);
* ``"truncate"`` — keep the first seq_len tokens;
* ``"error"`` — raise.

Returns per-row ``positions`` as well: each document's tokens are
numbered from 0, which is what position embeddings should consume for
packed data (a model indexing positions by row offset would give the
second document in a row wrong positions).
"""

import numpy as np


def pack_documents(docs, seq_len, oversize="split", min_fill=0.0):
    """Pack variable-length token sequences.

    Args:
      docs: iterable of 1-D int sequences (lists or arrays).
      seq_len: the fixed row length.
      oversize: "split" | "truncate" | "error" (see module docstring).
      min_fill: drop trailing rows filled below this fraction (0 keeps
        every row; e.g. 0.25 drops a last row holding only a tail).

    Returns:
      dict of int32 arrays ``tokens`` (n, seq_len), ``segment_ids``
      (n, seq_len; 0 = padding, 1..k = documents in row order), and
      ``positions`` (n, seq_len; 0-based within each document).
    """
    if seq_len <= 0:
        raise ValueError("seq_len must be positive")
    if oversize not in ("split", "truncate", "error"):
        raise ValueError("oversize must be split|truncate|error")

    pieces = []
    for doc in docs:
        arr = np.asarray(doc, np.int32).reshape(-1)
        if len(arr) == 0:
            continue
        if len(arr) > seq_len:
            if oversize == "error":
                raise ValueError(
                    "document of {} tokens exceeds seq_len {}".format(
                        len(arr), seq_len))
            if oversize == "truncate":
                pieces.append(arr[:seq_len])
            else:
                pieces.extend(arr[i:i + seq_len]
                              for i in range(0, len(arr), seq_len))
        else:
            pieces.append(arr)

    rows = []
    cur, cur_len = [], 0
    for piece in pieces:
        if cur_len + len(piece) > seq_len:
            rows.append(cur)
            cur, cur_len = [], 0
        cur.append(piece)
        cur_len += len(piece)
    if cur:
        rows.append(cur)
    if rows and min_fill > 0:
        fill = sum(len(p) for p in rows[-1]) / seq_len
        if fill < min_fill:
            rows.pop()

    n = len(rows)
    tokens = np.zeros((n, seq_len), np.int32)
    segments = np.zeros((n, seq_len), np.int32)
    positions = np.zeros((n, seq_len), np.int32)
    for r, row in enumerate(rows):
        off = 0
        for seg, piece in enumerate(row, start=1):
            k = len(piece)
            tokens[r, off:off + k] = piece
            segments[r, off:off + k] = seg
            positions[r, off:off + k] = np.arange(k, dtype=np.int32)
            off += k
    return {"tokens": tokens, "segment_ids": segments,
            "positions": positions}


def unpack_documents(packed):
    """Inverse of :func:`pack_documents` (modulo oversize handling):
    the list of documents in packing order."""
    tokens = np.asarray(packed["tokens"])
    segments = np.asarray(packed["segment_ids"])
    docs = []
    for r in range(tokens.shape[0]):
        for seg in range(1, int(segments[r].max(initial=0)) + 1):
            mask = segments[r] == seg
            if mask.any():
                docs.append(tokens[r][mask].copy())
    return docs


def packing_efficiency(packed):
    """Fraction of positions carrying real tokens (1 - padding share)."""
    segments = np.asarray(packed["segment_ids"])
    if segments.size == 0:
        return 0.0
    return float((segments != 0).mean())


def packed_batches(docs, seq_len, batch_rows, oversize="split",
                   min_fill=0.0, drop_remainder=True, target_key="y"):
    """Stream fixed-shape packed LM batches from a document iterator —
    the framework's packing path. Wraps any document
    source (an ``InputPipeline`` transform's output, a ``DataFeed``
    batch iterator, a corpus file) and yields Trainer-ready batches::

        {"x": (batch_rows, seq_len) int32, "y": ...,
         "segment_ids": ..., "positions": ...}

    ``x`` and ``y`` both carry the packed tokens (the LM convention the
    Trainer's loss consumes), the
    loss mask defaults from ``segment_ids`` inside the Trainer, and the
    model derives per-document positions itself when ``positions`` are
    dropped — but they ride along so a zigzag caller can permute them.

    Packing is row-local, so streaming = pack each chunk of documents
    as it arrives and carry leftover rows into the next batch; document
    order is preserved. With ``drop_remainder`` the trailing partial
    batch is dropped (steps want fixed shapes); otherwise it is
    zero-padded to ``batch_rows`` with all-padding rows (segment 0
    everywhere, so attention/loss ignore them).
    """
    pend = []  # packed row dicts awaiting emission

    def _emit():
        rows = pend[:batch_rows]
        del pend[:batch_rows]
        batch = {
            "x": np.stack([r["tokens"] for r in rows]),
            "segment_ids": np.stack([r["segment_ids"] for r in rows]),
            "positions": np.stack([r["positions"] for r in rows]),
        }
        batch[target_key] = batch["x"]
        return batch

    buf = []
    for doc in docs:
        buf.append(np.asarray(doc))
        if len(buf) >= 4 * batch_rows:  # pack in chunks, keep order
            packed = pack_documents(buf, seq_len, oversize=oversize)
            buf = []
            for i in range(packed["tokens"].shape[0]):
                pend.append({k: v[i] for k, v in packed.items()})
            while len(pend) >= batch_rows:
                yield _emit()
    if buf:
        packed = pack_documents(buf, seq_len, oversize=oversize,
                                min_fill=min_fill)
        for i in range(packed["tokens"].shape[0]):
            pend.append({k: v[i] for k, v in packed.items()})
    while len(pend) >= batch_rows:
        yield _emit()
    if pend and not drop_remainder:
        zero = {"tokens": np.zeros(seq_len, np.int32),
                "segment_ids": np.zeros(seq_len, np.int32),
                "positions": np.zeros(seq_len, np.int32)}
        while len(pend) < batch_rows:
            pend.append(dict(zero))
        yield _emit()
