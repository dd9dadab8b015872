"""Wide & Deep CTR model (port of ``models/wide_deep.py``).

The deep path: one embedding table per categorical feature (``embed_<i>``,
ids clipped into the table, rows cast to ``dtype``), concatenated with the
numeric features cast to ``dtype``, then ReLU dense layers (``Dense_0``,
...). The wide path: the hashed cross of all categorical ids looks up an
f32 table (``wide_table``, zeros at init). The logits are the wide path's
plus the deep path's f32 ``Dense``.

The hash is the JAX one in int32: ``mix = mix * 1000003 + id`` over the
features, wrapping in two's complement; ``abs`` leaves INT32_MIN negative,
as ``jnp.abs`` does; the bucket is the floor modulo (``torch.remainder``,
not ``fmod``), so a negative ``mix`` lands in ``[0, buckets)`` where
``jnp``'s ``%`` puts it. The ids are taken as int32 first: int64 ids,
torch's default, would wrap elsewhere and give other buckets.

The JAX module reads the numeric width at ``init``; the port's takes
``num_numeric`` (default 13, Criteo's). The forward takes
``(categorical, numeric)`` as two arguments or as one tuple — the tuple is
what ``train.Trainer`` hands a model whose batch ``"x"`` is a tuple.
"""

import torch
import torch.nn.functional as F

from tensorflowonspark_tpu_torch.models import layers
from tensorflowonspark_tpu_torch.models.layers import Dense, Embed

HASH_MULTIPLIER = 1000003


def wide_hash(categorical, buckets):
    """The wide path's bucket per row of int ids (B, F), in int32."""
    ids = categorical.to(torch.int32)
    mix = torch.zeros_like(ids[:, 0])
    for i in range(ids.shape[1]):
        mix = mix * HASH_MULTIPLIER + ids[:, i]
    return torch.remainder(torch.abs(mix), buckets)


class WideDeep(layers.ZooModel):
    """``categorical``: int ids (B, len(vocab_sizes)); ``numeric``: floats
    (B, num_numeric). Returns f32 logits (B, num_classes)."""

    def __init__(self, vocab_sizes, embed_dim=32, deep_features=(256, 128, 64),
                 wide_hash_buckets=2 ** 18, num_classes=2,
                 dtype=torch.bfloat16, num_numeric=13, *, device="cuda",
                 seed=0):
        super().__init__()
        self.vocab_sizes = tuple(vocab_sizes)
        self.wide_hash_buckets = wide_hash_buckets
        self.dtype = dtype
        self.embeds = [
            self.sub(Embed(vocab, embed_dim, dtype), "embed_{}".format(i))
            for i, vocab in enumerate(self.vocab_sizes)]
        width = len(self.vocab_sizes) * embed_dim + num_numeric
        self.deep = []
        for out in deep_features:
            self.deep.append(self.sub(Dense(width, out, dtype)))
            width = out
        self.wide_table = self.sub(
            Embed(wide_hash_buckets, num_classes, torch.float32, init_std=0),
            "wide_table")
        self.deep_head = self.sub(Dense(width, num_classes, torch.float32))
        self._finish(device, seed)

    def forward(self, categorical, numeric=None):
        if numeric is None:
            categorical, numeric = categorical
        categorical = torch.as_tensor(categorical, device=self.device)
        numeric = torch.as_tensor(numeric, device=self.device)
        embeds = [table(categorical[:, i].clamp(0, vocab - 1))
                  for i, (table, vocab) in enumerate(zip(self.embeds,
                                                         self.vocab_sizes))]
        deep = torch.cat(embeds + [numeric.to(self.dtype)], dim=-1)
        for dense in self.deep:
            deep = F.relu(dense(deep))
        wide = self.wide_table(wide_hash(categorical,
                                         self.wide_hash_buckets))
        return wide + self.deep_head(deep)
