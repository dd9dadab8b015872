"""ML-pipeline integration: the ``TFEstimator`` / ``TFModel`` pair (port of
``pipeline.py``).

An Estimator that runs distributed training over a backend's executors and
returns a Model doing embarrassingly-parallel per-executor inference (the
reference's stated semantics, ``pipeline.py:6-9``). DataFrames map to
:class:`~tensorflowonspark_tpu_torch.data.dfutil.Table`; SavedModels map to
:mod:`tensorflowonspark_tpu_torch.export` directories; checkpoints map to
:mod:`tensorflowonspark_tpu_torch.train.checkpoint` directories. Not to be
confused with :mod:`tensorflowonspark_tpu_torch.parallel.pipeline`
(pipeline parallelism).

Parity map (the JAX package's ``pipeline.py``):

* the ``Has*`` Param mixins — same names, same defaults — plus
  ``HasDevice`` (``"cuda"``): the device ``TFModel`` loads its model onto
  on each executor (``"cpu"`` runs there, as the tests do); the merged
  args carry it to ``train_fn`` too;
* ``Namespace`` argv/dict adapter and ``TFParams.merge_args_params``;
* ``TFEstimator._fit``: FILES-mode TFRecord export with loaded-table origin
  reuse, cluster run/train/shutdown, optional single-executor
  ``export_fn``;
* ``TFModel.transform``: per-executor cached model (the ``global_sess``
  analog), SavedModel-or-checkpoint restore onto the executor's device,
  batched prediction via ``yield_batch`` with ``train.prefetch.
  DevicePrefetch`` placing each batch, rows re-aligned 1:1 with the input.

Executors start by spawn (``backend.LocalBackend``): ``train_fn``,
``export_fn``, ``model_registrar`` and the tasks built around them
(``_ExportTask``, ``_RunModel``) travel pickled (cloudpickle), so they
must pickle — module-level functions or callable objects, whose modules
the executors can import.
"""

import copy
import logging
import os

import numpy as np

from tensorflowonspark_tpu_torch import backend as backend_mod
from tensorflowonspark_tpu_torch import cluster as cluster_mod
from tensorflowonspark_tpu_torch import export as export_lib
from tensorflowonspark_tpu_torch.cluster import InputMode
from tensorflowonspark_tpu_torch.data import dfutil

logger = logging.getLogger(__name__)


class Namespace(object):
    """Argv/dict adapter (reference ``pipeline.py:268-308``): lets user code
    written against ``argparse`` results also accept dicts or other
    namespaces, and supports merging."""

    def __init__(self, d=None, **kwargs):
        if d is None:
            d = {}
        elif isinstance(d, Namespace):
            d = dict(d.__dict__)
        elif not isinstance(d, dict):
            # argparse.Namespace or similar attribute bag; argv lists pass
            # through unchanged as the reference's ARGV mode.
            if isinstance(d, (list, tuple)):
                raise TypeError(
                    "Namespace does not wrap argv lists; pass them straight "
                    "to the estimator as tf_args"
                )
            d = dict(vars(d))
        self.__dict__.update(d)
        self.__dict__.update(kwargs)

    def __contains__(self, key):
        return key in self.__dict__

    def __eq__(self, other):
        if isinstance(other, Namespace):
            return self.__dict__ == other.__dict__
        return NotImplemented

    def __repr__(self):  # pragma: no cover - debugging aid
        return "Namespace({})".format(self.__dict__)

    def merge(self, other):
        d = dict(self.__dict__)
        d.update(other.__dict__ if isinstance(other, Namespace) else other)
        return Namespace(d)


# ---------------------------------------------------------------------------
# Params (reference pipeline.py:50-265)
# ---------------------------------------------------------------------------


class Params(object):
    """Tiny Param store: declared defaults, chained setters, getters.

    The Spark ML ``Params`` machinery (uid registry, doc objects) collapses
    to a dict here; the mixin surface (``setBatchSize`` etc.) is preserved
    so reference-style pipelines read the same.
    """

    def __init__(self):
        self._paramMap = {}
        for klass in type(self).__mro__:
            for name, default in getattr(klass, "_param_defaults", {}).items():
                self._paramMap.setdefault(name, default)

    def _set(self, **kwargs):
        self._paramMap.update(kwargs)
        return self

    def _get(self, name):
        return self._paramMap.get(name)


def _mixin(param, default, set_name, get_name):
    """Build a Has<X> mixin with setX/getX accessors."""

    def setter(self, value):
        return self._set(**{param: value})

    def getter(self):
        return self._get(param)

    return type(
        "Has" + param[0].upper() + param[1:],
        (Params,),
        {
            "_param_defaults": {param: default},
            set_name: setter,
            get_name: getter,
        },
    )


HasBatchSize = _mixin("batch_size", 100, "setBatchSize", "getBatchSize")
HasClusterSize = _mixin("cluster_size", 1, "setClusterSize", "getClusterSize")
HasEpochs = _mixin("epochs", 1, "setEpochs", "getEpochs")
HasInputMapping = _mixin("input_mapping", None, "setInputMapping", "getInputMapping")
HasOutputMapping = _mixin("output_mapping", None, "setOutputMapping", "getOutputMapping")
HasInputMode = _mixin("input_mode", InputMode.FEED, "setInputMode", "getInputMode")
HasMasterNode = _mixin("master_node", None, "setMasterNode", "getMasterNode")
HasModelDir = _mixin("model_dir", None, "setModelDir", "getModelDir")
HasNumPS = type(
    "HasNumPS",
    (Params,),
    {
        "_param_defaults": {"num_ps": 0, "driver_ps_nodes": False},
        "setNumPS": lambda self, v: self._set(num_ps=v),
        "getNumPS": lambda self: self._get("num_ps"),
        "setDriverPSNodes": lambda self, v: self._set(driver_ps_nodes=v),
        "getDriverPSNodes": lambda self: self._get("driver_ps_nodes"),
    },
)
HasProtocol = _mixin("protocol", "ici", "setProtocol", "getProtocol")
HasReaders = _mixin("readers", 1, "setReaders", "getReaders")
HasSteps = _mixin("steps", 1000, "setSteps", "getSteps")
HasTensorboard = _mixin("tensorboard", False, "setTensorboard", "getTensorboard")
HasTFRecordDir = _mixin("tfrecord_dir", None, "setTFRecordDir", "getTFRecordDir")
HasExportDir = _mixin("export_dir", None, "setExportDir", "getExportDir")
HasSignatureDefKey = _mixin(
    "signature_def_key", None, "setSignatureDefKey", "getSignatureDefKey"
)
HasTagSet = _mixin("tag_set", export_lib.DEFAULT_TAG, "setTagSet", "getTagSet")
# Per-phase deadline (seconds) for feed/shutdown/export/transform jobs.
# No Spark analog (Spark's driver could be killed from outside); here the
# driver owns straggler reaping — a job past its deadline SIGKILLs the
# wedged executors (backend.Job.wait) and fails loudly instead of
# hanging the caller. Default None: deadlines are opt-in, since a
# legitimate long fit must not be reaped (the shutdown phase keeps its
# own 600s default — by then all feeding is done).
HasTimeout = _mixin("timeout", None, "setTimeout", "getTimeout")
# The port's own: where TFModel loads its model on each executor (and what
# train_fn reads from the merged args). The card unless "cpu" is asked for.
HasDevice = _mixin("device", "cuda", "setDevice", "getDevice")
HasModelMeta = type(
    "HasModelMeta",
    (Params,),
    {
        # Checkpoint restores need the registry model identity — our
        # checkpoints hold arrays, not programs (export.py docstring).
        # model_registrar: optional callable shipped to executors and
        # invoked before resolving model_name — how user-defined (non-zoo)
        # models become loadable by name on fresh executor processes (the
        # reference's keras path shipped the model-building code the same
        # way, inside the Spark closure).
        "_param_defaults": {"model_name": None, "model_kwargs": None,
                            "model_registrar": None},
        "setModelName": lambda self, v: self._set(model_name=v),
        "getModelName": lambda self: self._get("model_name"),
        "setModelKwargs": lambda self, v: self._set(model_kwargs=v),
        "getModelKwargs": lambda self: self._get("model_kwargs"),
        "setModelRegistrar": lambda self, v: self._set(model_registrar=v),
        "getModelRegistrar": lambda self: self._get("model_registrar"),
    },
)


class TFParams(
    HasBatchSize, HasClusterSize, HasEpochs, HasInputMapping, HasOutputMapping,
    HasInputMode, HasMasterNode, HasModelDir, HasNumPS, HasProtocol,
    HasReaders, HasSteps, HasTensorboard, HasTFRecordDir, HasExportDir,
    HasSignatureDefKey, HasTagSet, HasTimeout, HasModelMeta, HasDevice,
):
    """All pipeline params (reference ``TFParams``, ``pipeline.py:311-320``)."""

    def merge_args_params(self, args=None):
        """Overlay this object's params onto ``args`` (params win), returning
        a :class:`Namespace` — reference ``merge_args_params``
        (``pipeline.py:311-320``). An argv *list* gets params appended as
        ``--flag value`` pairs, the reference's ARGV mode."""
        if isinstance(args, (list, tuple)):
            merged = list(args)
            for name, value in sorted(self._paramMap.items()):
                if value is not None:
                    merged += ["--" + name, str(value)]
            return merged
        base = Namespace(args) if args is not None else Namespace()
        # None-valued params are unset defaults, not overrides — they must
        # not clobber values the user supplied in tf_args.
        overrides = {k: v for k, v in self._paramMap.items() if v is not None}
        merged = base.merge(overrides)
        for name, default in self._paramMap.items():
            if name not in merged:
                setattr(merged, name, default)
        return merged

    def _input_columns(self, table):
        """The sorted input columns a fit/transform consumes — the
        ``input_mapping`` keys when set, else the table schema (the
        reference's ``df.select(sorted(cols))``, ``pipeline.py:404``)."""
        if self._get("input_mapping"):
            return sorted(self._get("input_mapping"))
        if table.schema:
            return sorted(table.schema)
        if len(table):
            return sorted(table[0])
        raise ValueError("cannot determine input columns of an empty table")


# ---------------------------------------------------------------------------
# Estimator (reference pipeline.py:323-420)
# ---------------------------------------------------------------------------


class TFEstimator(TFParams):
    """Distributed-training estimator over a backend's executors.

    ``train_fn(args, ctx)`` is the per-node program (the reference's
    ``map_fun``); ``export_fn(args)`` optionally runs once on a single
    executor after training to produce the export directory
    (``pipeline.py:409-418``). Both run in spawned executor processes, so
    both must pickle (see the module docstring).
    """

    def __init__(self, train_fn, tf_args=None, export_fn=None):
        super().__init__()
        self.train_fn = train_fn
        self.export_fn = export_fn
        self.tf_args = tf_args

    def fit(self, table, backend=None):
        local_backend = backend is None
        if local_backend:
            backend = backend_mod.LocalBackend(self._get("cluster_size"))
        try:
            self._fit(table, backend)
        finally:
            if local_backend:
                backend.stop()
        model = TFModel(self.tf_args)
        model._paramMap.update(copy.deepcopy(self._paramMap))
        return model

    def _fit(self, table, backend):
        input_mode = self._get("input_mode")
        cluster_size = self._get("cluster_size")
        num_ps = self._get("num_ps")

        if input_mode == InputMode.FILES:
            # Materialize the table as TFRecords unless it already came from
            # a TFRecord dir (loaded-table origin reuse, pipeline.py:384-397).
            if dfutil.is_loaded_table(table):
                self._set(tfrecord_dir=table.origin)
                logger.info("reusing TFRecord origin %s", table.origin)
            else:
                tfrecord_dir = self._get("tfrecord_dir")
                if not tfrecord_dir:
                    raise ValueError(
                        "InputMode.FILES requires tfrecord_dir (setTFRecordDir)"
                    )
                # Always materialize the table being fit: a non-empty dir
                # may hold a previous table's records, and training on stale
                # data silently would be worse than the re-export cost.
                cols = self._input_columns(table)
                schema = {c: table.schema[c] for c in cols} if table.schema else None
                rows = [{c: row[c] for c in cols} for row in table]
                dfutil.save_as_tfrecords(
                    rows, tfrecord_dir, schema=schema,
                    num_shards=max(1, cluster_size - num_ps),
                )

        args = self.merge_args_params(self.tf_args)
        logger.info("training with args: %s",
                    args if isinstance(args, list) else args.__dict__)
        cluster = cluster_mod.run(
            backend, self.train_fn, tf_args=args,
            num_executors=cluster_size, num_ps=num_ps,
            input_mode=input_mode, master_node=self._get("master_node"),
            tensorboard=self._get("tensorboard"),
            log_dir=self._get("model_dir"),
            driver_ps_nodes=self._get("driver_ps_nodes"),
        )
        timeout = self._get("timeout")
        if input_mode == InputMode.FEED:
            rows = self._feed_rows(table)
            dataset = backend_mod.Partitioned.from_items(
                rows, max(1, cluster_size - num_ps)
            )
            cluster.train(dataset, num_epochs=self._get("epochs"),
                          timeout=timeout)
        cluster.shutdown(timeout=timeout or 600)

        if self.export_fn:
            if not self._get("export_dir"):
                raise ValueError("export_fn requires export_dir (setExportDir)")
            logger.info("running export_fn on one executor")
            backend.foreach_partition(
                [[0]], _ExportTask(self.export_fn, args), block=True,
                timeout=timeout,
            )

    def _feed_rows(self, table):
        """Rows as value-tuples in sorted-column order — the reference feeds
        ``df.select(sorted(cols)).rdd`` (``pipeline.py:404``)."""
        cols = self._input_columns(table)
        return [[row[c] for c in cols] for row in table]


class _ExportTask(object):
    """Single-executor export closure (reference ``pipeline.py:409-418``);
    pickled to the executor with ``export_fn`` and the merged args."""

    def __init__(self, export_fn, args):
        self.export_fn = export_fn
        self.args = args

    def __call__(self, iterator):
        for _ in iterator:
            pass
        self.export_fn(self.args)
        return []


# ---------------------------------------------------------------------------
# Model (reference pipeline.py:423-598)
# ---------------------------------------------------------------------------

# Per-process model cache: the reference's `global_sess` keyed by args
# (pipeline.py:478-538). Executors are persistent processes, so a model
# loads once per executor regardless of partition count.
_model_cache = {}


class TFModel(TFParams):
    """Per-executor single-node inference over exported models, on each
    executor's ``device`` (``setDevice``; the card by default)."""

    def __init__(self, tf_args=None):
        super().__init__()
        self.tf_args = tf_args

    def transform(self, table, backend=None):
        params = dict(self._paramMap)
        if not params.get("export_dir") and not params.get("model_dir"):
            raise ValueError("transform requires export_dir or model_dir")
        cols = self._input_columns(table)
        rows = [[row[c] for c in cols] for row in table]
        num_parts = max(1, min(params["cluster_size"], max(1, len(rows))))

        local_backend = backend is None
        if local_backend:
            backend = backend_mod.LocalBackend(num_parts)
        try:
            parts = backend_mod.Partitioned.from_items(rows, num_parts)
            results = backend.map_partitions(
                parts, _RunModel(params, cols), timeout=params.get("timeout")
            )
        finally:
            if local_backend:
                backend.stop()

        # Undo the round-robin split so output rows align 1:1 with input.
        out_rows = [None] * len(rows)
        for i, part in enumerate(results):
            out_rows[i::num_parts] = part
        schema = (
            dfutil.infer_schema_from_row(out_rows[0]) if out_rows else {}
        )
        return dfutil.Table(out_rows, schema=schema)


class _RunModel(object):
    """The per-partition inference closure (reference ``_run_model``,
    ``pipeline.py:478-562``): cached model, batched prediction. Pickled to
    the executors with the params (``model_registrar`` included)."""

    def __init__(self, params, input_columns):
        self.params = params
        self.input_columns = list(input_columns)

    def _cache_key(self):
        p = self.params
        # repr: a tag_set set from the CLI is a list (unhashable as such).
        return (p.get("export_dir"), p.get("model_dir"),
                p.get("signature_def_key"), repr(p.get("tag_set")),
                p.get("model_name"), repr(p.get("model_kwargs")),
                p.get("device"))

    def _load(self):
        key = self._cache_key()
        model = _model_cache.get(key)
        if model is None:
            p = self.params
            if p.get("model_registrar"):
                p["model_registrar"]()  # register user models on this executor
            if p.get("export_dir"):
                model = export_lib.load_saved_model(
                    p["export_dir"],
                    signature_def_key=p.get("signature_def_key"),
                    tag_set=p.get("tag_set"), device=p["device"],
                )
            else:
                if not p.get("model_name"):
                    raise ValueError(
                        "checkpoint inference requires model_name "
                        "(setModelName) to rebuild the model program"
                    )
                model = export_lib.load_from_checkpoint(
                    p["model_dir"], p["model_name"],
                    model_kwargs=p.get("model_kwargs"),
                    signature_def_key=p.get("signature_def_key"),
                    device=p["device"],
                )
            _model_cache[key] = model
        return model

    def _build_feed(self, batch, input_mapping, aliases):
        if input_mapping:
            feed = {}
            for ci, col in enumerate(self.input_columns):
                alias = input_mapping.get(col)
                if alias is not None:
                    feed[alias] = np.asarray([row[ci] for row in batch])
            return feed
        if len(aliases) == 1:
            # Rows are per-column value lists; a single selected column
            # feeds its values directly (no spurious length-1 axis),
            # multiple scalar columns stack into a feature axis.
            if len(self.input_columns) == 1:
                return {aliases[0]: np.asarray([row[0] for row in batch])}
            return {aliases[0]: np.asarray(batch)}
        raise ValueError("multi-input signature requires input_mapping")

    def __call__(self, iterator):
        from tensorflowonspark_tpu_torch.train import prefetch as prefetch_lib

        model = self._load()
        p = self.params
        input_mapping = p.get("input_mapping") or {}
        # column name -> signature input alias; without a mapping a
        # single-input signature takes all columns stacked.
        aliases = model.input_aliases
        out_aliases = model.output_aliases
        output_mapping = p.get("output_mapping") or {
            alias: "output_{}".format(i) if len(out_aliases) > 1 else "output"
            for i, alias in enumerate(out_aliases)
        }

        def feeds():
            for batch in yield_batch(iterator, p["batch_size"]):
                yield len(batch), self._build_feed(
                    batch, input_mapping, aliases)

        results = []
        # Device-side prefetch (train/prefetch.py): batch assembly and the
        # host->device transfer of feed N+1 overlap the forward pass of
        # feed N — LoadedModel.predict passes tensors already on its
        # device straight into its forward. The batch count rides as a
        # plain int leaf outside the feed dict (ints are not placed).
        # Partitions here are in-memory row lists (backend.py), so a
        # producer thread that outlives an exceptional close() is reading
        # a local iterator, not a shared executor stream.
        pf = prefetch_lib.DevicePrefetch(feeds(), depth=2, device=p["device"])
        try:
            self._predict_batches(pf, model, output_mapping, results)
        finally:
            pf.close()
        return results

    def _predict_batches(self, pf, model, output_mapping, results):
        for n, feed in pf:
            out = model.predict(feed)
            named = {}
            for alias, col in sorted(output_mapping.items()):
                vals = np.asarray(out[alias])
                if vals.shape[0] != n:
                    raise ValueError(
                        "output {!r} batch dim {} != input batch {}".format(
                            alias, vals.shape[0], n
                        )
                    )
                named[col] = vals
            for i in range(n):
                row = {}
                for col, vals in named.items():
                    v = vals[i]
                    row[col] = v.tolist() if v.ndim else v.item()
                results.append(row)
        return results


def yield_batch(iterator, batch_size):
    """Group an iterator into lists of up to ``batch_size`` (reference
    ``yield_batch``, ``pipeline.py:621-643``; the short final batch is
    yielded as-is)."""
    batch = []
    for item in iterator:
        batch.append(item)
        if len(batch) >= batch_size:
            yield batch
            batch = []
    if batch:
        yield batch
