"""Data tier of the port (the JAX package's ``data/``): TFRecord codec
(native C++ built with the host compiler, with a Python fallback),
``tf.train.Example`` wire codec, columnar batch decode, table <-> TFRecord
conversion, sequence packing, the FILES-mode ``InputPipeline`` with its
decode pool and batch cache, and image preprocessing. Host code on numpy:
the modules import no ``torch`` at module level (``input_normalizer``
imports it when called), so decode workers start light.
"""

from tensorflowonspark_tpu_torch.data.tfrecord import (  # noqa: F401
    RecordReader,
    RecordWriter,
    read_records,
    write_records,
)
from tensorflowonspark_tpu_torch.data.example import (  # noqa: F401
    Example,
    decode_example,
    encode_example,
)
from tensorflowonspark_tpu_torch.data.batch_decode import (  # noqa: F401
    decode_batch,
    read_columns,
)
from tensorflowonspark_tpu_torch.data.decode_pool import (  # noqa: F401
    DecodeError,
    DecodePool,
)
from tensorflowonspark_tpu_torch.data.batch_cache import (  # noqa: F401
    BatchCacheReader,
    BatchCacheWriter,
)
