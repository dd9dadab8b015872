"""Stream sentinels for the feed plane.

Capability parity with the reference's queue markers
(``tensorflowonspark/marker.py:11-18``): ``EndPartition``
keeps per-partition output alignment during inference, and ``None`` on a
queue still means end-of-feed. ``EndEpoch`` is new (the reference emulated
epochs by unioning the RDD with itself, ``TFCluster.py:86-90``; an input
pipeline wants an explicit epoch boundary instead).
"""


class Marker:
    """Base class for in-band stream control messages."""

    __slots__ = ()

    def __repr__(self):  # pragma: no cover - trivial
        return "<{}>".format(type(self).__name__)


class EndPartition(Marker):
    """Marks the end of one input partition (keeps inference outputs aligned)."""

    __slots__ = ()


class EndEpoch(Marker):
    """Marks the end of one pass over the dataset."""

    __slots__ = ()
