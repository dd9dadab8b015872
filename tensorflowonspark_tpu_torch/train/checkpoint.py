"""Checkpoint and resume (port of ``train/checkpoint.py``).

Two parts. The commit-marker protocol is the JAX package's, byte for byte,
because its supervisor reads it: a step is *committed* only when
``.tfos-commit-<step>.json`` beside the step directory exists and every
file of its manifest ``{"step": int, "files": {relpath: size}}`` is present
at its recorded size. A crash mid-write leaves no marker, or one that no
longer validates, so a restart never restores a partial save; the JAX
package's :func:`latest_committed_step` and this module's give the same
answer on either package's trees.

The step format is the port's own (orbax is not available to it):
``<dir>/<step>/default/`` holds ``params.pt``, ``model_state.pt`` and
``opt_state.pt``, written by ``torch.save``: the state's parameters and
buffers as CPU ``state_dict``s and ``optimizer.state_dict()``. A step is
written under a temporary name that is not a number and renamed to
``<step>``; only then is its marker written. Step listing reads numeric
names only, so temporary and ``.force-backup-<step>`` directories are
never steps. When to save and which steps ``max_to_keep`` deletes follow
orbax's ``CheckpointManager`` (:class:`_StepStore`).

Under a multi-process runtime (``torch.distributed``) the save is
collective, as the JAX package's is: every rank calls
:meth:`CheckpointManager.save`, every rank makes the same save decision,
rank 0 alone writes the step and its marker, and a barrier on the CPU
group stands on each side of the commit, so that no rank goes on to read a
half-committed step. A state whose parameters are sharded over a mesh
(``TrainState.sharding``) is written whole: every rank takes part in
gathering each parameter and each of its optimizer moments to the full
tensor, and the step holds the same full tree an unsharded run writes. A
restore cuts each rank's shards out of the full tree, so a step saved
under one mesh restores under any other (``fsdp=2, tensor=2`` and
``data=1`` alike), and :meth:`CheckpointManager.restore_variables` serves
it as it is.
"""

import contextlib
import copy
import dataclasses
import hashlib
import json
import logging
import os
import shutil
import tempfile
import threading
import time
import uuid

import torch

from tensorflowonspark_tpu_torch import fs as fs_lib
from tensorflowonspark_tpu_torch import telemetry
from tensorflowonspark_tpu_torch.parallel import multihost

logger = logging.getLogger(__name__)

# Commit markers live NEXT TO the step dirs (".tfos-commit-<step>.json"),
# never inside them. A marker records the step's file manifest
# {relpath: size}; a step is committed only when its marker exists and
# every manifest file is present at its recorded size.
_MARKER_PREFIX = ".tfos-commit-"
# The item directory inside a step and the files a step holds.
ITEM = "default"
PARAMS, MODEL_STATE, OPT_STATE = "params.pt", "model_state.pt", "opt_state.pt"
_TMP_PREFIX = ".tmp-step-"


def _marker_name(step):
    return "{}{}.json".format(_MARKER_PREFIX, int(step))


def _marker_step(name):
    """The step of a marker filename, or None."""
    if not (name.startswith(_MARKER_PREFIX) and name.endswith(".json")):
        return None
    try:
        return int(name[len(_MARKER_PREFIX):-len(".json")])
    except ValueError:
        return None


def _step_manifest(step_dir):
    """``{relative path: size}`` of every regular file under a step dir."""
    files = {}
    for root, _, names in os.walk(step_dir):
        rel_root = os.path.relpath(root, step_dir)
        for name in names:
            rel = (name if rel_root == "." else
                   "/".join(rel_root.split(os.sep) + [name]))
            files[rel] = os.path.getsize(os.path.join(root, name))
    return files


def latest_committed_step(directory):
    """Newest step under ``directory`` whose commit marker validates.

    The supervisor's probe, the JAX package's to the line: it scans the
    filesystem directly, so it can classify a tree another process is
    writing. Returns None when no step is committed (marker-less trees
    included). For ``gs://`` trees, which the JAX package writes without
    markers, it reports the newest step directory.
    """
    directory = os.fspath(directory)
    if directory.startswith("gs://"):
        fs, root = fs_lib.get_fs(directory)
        if not fs.exists(root.rstrip("/")):
            return None
        steps = [
            int(name) for name in (
                e.rstrip("/").rsplit("/", 1)[-1]
                for e in fs.ls(root.rstrip("/"), detail=False)
            ) if name.isdigit()
        ]
        return max(steps) if steps else None
    if fs_lib.is_local(directory):
        root = os.path.abspath(fs_lib.local_path(directory))
        if not os.path.isdir(root):
            return None
        names = os.listdir(root)
        sizes = None
    else:
        fs, root = fs_lib.get_fs(directory)
        root = root.rstrip("/")
        if not fs.exists(root):
            return None
        names = [e.rstrip("/").rsplit("/", 1)[-1]
                 for e in fs.ls(root, detail=False)]
        sizes = fs

    for step in sorted(
            (s for s in map(_marker_step, names) if s is not None),
            reverse=True):
        marker = "/".join([root, _marker_name(step)]) if sizes else \
            os.path.join(root, _marker_name(step))
        try:
            if sizes:
                with sizes.open(marker) as f:
                    doc = json.loads(f.read().decode("utf-8"))
            else:
                with open(marker) as f:
                    doc = json.load(f)
        except (OSError, ValueError):
            continue
        manifest = doc.get("files") or {}
        if not manifest:
            continue
        step_dir = (
            "/".join([root, str(step)]) if sizes
            else os.path.join(root, str(step))
        )
        ok = True
        for rel, size in manifest.items():
            path = (step_dir + "/" + rel if sizes
                    else os.path.join(step_dir, *rel.split("/")))
            try:
                actual = (sizes.info(path)["size"] if sizes
                          else os.path.getsize(path))
            except (OSError, KeyError, FileNotFoundError):
                ok = False
                break
            if actual != size:
                ok = False
                break
        if ok:
            return step
    return None


class StepAlreadyExistsError(ValueError):
    """A save at a step whose directory exists (orbax's error)."""


class _StepStore:
    """The step directories of one checkpoint dir and orbax's decisions
    over them (``orbax.checkpoint.CheckpointManager`` with
    ``save_interval_steps`` and ``max_to_keep``):

    * steps are tracked in a list, read sorted from disk at start and on
      :meth:`reload`, then appended in save order; the latest step is the
      list's last entry;
    * a save without ``force`` is declined when the latest step is at or
      past ``step``; otherwise it is made when ``step`` is a multiple of
      ``save_interval_steps`` or no step exists yet; ``force`` skips that
      decision, and a save at a listed step raises;
    * after each save the list's first ``len - max_to_keep`` entries are
      deleted (list order, not step order);
    * an asynchronous save writes on a thread; the next save, and
      :meth:`wait_until_finished`, wait for it, and a failed write raises
      there and leaves the list.
    """

    def __init__(self, directory, max_to_keep, save_interval_steps,
                 async_checkpointing, writer=True):
        self._dir = directory
        self._max_to_keep = max_to_keep
        self._interval = int(save_interval_steps)
        self._async = async_checkpointing
        # A non-writer (a rank other than 0 of a collective save) keeps
        # the same step list and decisions but touches no file.
        self._writer = writer
        self._thread = None
        self._error = None
        if writer:
            for name in os.listdir(directory):
                if name.startswith(_TMP_PREFIX):  # a save cut short
                    shutil.rmtree(os.path.join(directory, name),
                                  ignore_errors=True)
        self.reload()

    def reload(self):
        self._steps = sorted(
            int(name) for name in os.listdir(self._dir)
            if name.isdigit() and os.path.isdir(os.path.join(self._dir, name)))

    def all_steps(self):
        return list(self._steps)

    def latest_step(self):
        return self._steps[-1] if self._steps else None

    def should_save(self, step):
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return step % self._interval == 0 or not self._steps

    def save(self, step, snapshot, force=False, collective=False):
        """Write ``snapshot()`` (the three objects of a step) as ``step``;
        returns whether a save was made. ``collective``: every rank calls
        ``snapshot`` (a sharded state's gather), the writer keeps it."""
        if not force and not self.should_save(step):
            return False
        self.wait_until_finished()
        if step in self._steps:
            raise StepAlreadyExistsError(
                "Checkpoint for step {} already exists.".format(step))
        objs = snapshot() if self._writer or collective else None
        if not self._writer:
            objs = None
        if not self._async:
            self._write(step, objs)  # a failed write leaves the list alone
        self._steps.append(step)
        n = self._max_to_keep
        drop = ([] if n is None or len(self._steps) <= n
                else self._steps[:len(self._steps) - n])
        self._steps = [s for s in self._steps if s not in drop]
        if self._async:
            self._thread = threading.Thread(
                target=self._write_async, args=(step, objs, drop),
                name="checkpoint-write", daemon=True)
            self._thread.start()
        else:
            self._delete_dirs(drop)
        return True

    def _write(self, step, objs):
        if not self._writer:
            return
        tmp = os.path.join(self._dir, "{}{}-{}".format(
            _TMP_PREFIX, step, uuid.uuid4().hex[:8]))
        try:
            os.makedirs(os.path.join(tmp, ITEM))
            for name, obj in zip((PARAMS, MODEL_STATE, OPT_STATE), objs):
                torch.save(obj, os.path.join(tmp, ITEM, name))
            os.rename(tmp, os.path.join(self._dir, str(step)))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def _delete_dirs(self, steps):
        if not self._writer:
            return
        for old in steps:
            shutil.rmtree(os.path.join(self._dir, str(old)),
                          ignore_errors=True)

    def _write_async(self, step, objs, drop):
        try:
            self._write(step, objs)
            self._delete_dirs(drop)
        except BaseException as e:  # raised by wait_until_finished
            self._error = (step, e)

    def wait_until_finished(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            (step, error), self._error = self._error, None
            self._steps = [s for s in self._steps if s != step]
            raise error

    def delete(self, step):
        if step not in self._steps:
            raise FileNotFoundError(
                "Requested deleting a non-existent step: {}.".format(step))
        if self._writer:
            shutil.rmtree(os.path.join(self._dir, str(step)))
        self._steps.remove(step)


def _host(tree, clone):
    """``tree`` with every tensor detached on the CPU; ``clone`` copies
    tensors that already lie there, so later in-place updates of the live
    state do not reach the snapshot."""
    if isinstance(tree, dict):
        return {k: _host(v, clone) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v, clone) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=clone)
    return copy.deepcopy(tree)


def _copy_into(live, saved, what):
    if set(live) != set(saved):
        raise KeyError(
            "checkpoint {} differ from the state's: missing {}, extra "
            "{}".format(what, sorted(set(live) - set(saved)),
                        sorted(set(saved) - set(live))))
    for name, t in live.items():
        t.copy_(saved[name])


class CheckpointManager:
    """Periodic save and latest-restore of a :class:`TrainState`.

    ``directory`` routing: local paths and ``file://`` are written in
    place; any other scheme (``gs://``, ``hdfs://``, ``memory://``, ...)
    writes a local mirror under the temporary directory that is uploaded
    after every save (step files before markers) and filled from the
    remote at start. ``async_checkpointing``: a save snapshots the state
    to host memory and returns; the files are written on a thread, and
    the marker only once :meth:`wait` or :meth:`close` has seen the write
    finish.

    In a multi-process runtime every rank constructs the manager over the
    same directory and calls :meth:`save`, :meth:`wait` and :meth:`close`
    together (the collective save of the module docstring).
    """

    def __init__(self, directory, max_to_keep=3, save_interval_steps=1,
                 async_checkpointing=False):
        directory = os.fspath(directory)
        self._remote = None
        self._multi = multihost.is_multiprocess()
        self._writer = multihost.process_index() == 0
        if fs_lib.is_local(directory):
            self._dir = os.path.abspath(fs_lib.local_path(directory))
            os.makedirs(self._dir, exist_ok=True)
        else:
            self._remote = directory.rstrip("/")
            # One deterministic mirror per URI on this host.
            digest = hashlib.sha1(self._remote.encode()).hexdigest()[:16]
            self._dir = os.path.join(
                tempfile.gettempdir(), "tfos-torch-ckpt-mirrors", digest)
            os.makedirs(self._dir, exist_ok=True)
            if self._writer:
                with self._mirror_lock():
                    self._reconcile_mirror()
        # Every rank lists the steps only once rank 0 has cleaned the dir.
        self._barrier()
        self._async = bool(async_checkpointing)
        self._own_saves = set()  # steps THIS manager wrote (see save)
        self._force_synced = set()  # force-rewritten steps (_sync_remote)
        self._pending_commit = set()  # async saves awaiting durability
        self._mgr = _StepStore(self._dir, max_to_keep, save_interval_steps,
                               self._async, writer=self._writer)

    def _barrier(self):
        if self._multi:
            multihost.barrier()

    def save(self, state, step=None, force=False):
        """Save ``state`` as ``step`` (default ``state.step``); returns
        whether a save was made. Without ``force`` the save interval
        decides and a step at or below the latest is declined. With
        ``force``, a step this manager already wrote is a no-op (same
        step, same state), and one written by someone else is rewritten."""
        step = int(step if step is not None else state.step)
        with telemetry.span("checkpoint/save", step=step,
                            force=bool(force)) as sp:
            t0 = time.monotonic()
            saved = self._save(state, step, force)
            if saved:
                # Async saves: the enqueue and snapshot cost; the durable
                # tail is checkpoint_commit_seconds.
                telemetry.observe("checkpoint_save_seconds",
                                  time.monotonic() - t0)
            sp.set(saved=bool(saved))
        return saved

    def _save(self, state, step, force):
        if force and step in self._mgr.all_steps():
            if step in self._own_saves:
                return False
            # Rewrite: copy the step aside first, so a failed save between
            # the delete and the finished rewrite keeps its only copy.
            step_dir = os.path.join(self._dir, str(step))
            backup = os.path.join(self._dir, ".force-backup-{}".format(step))
            if self._writer and os.path.isdir(step_dir):
                shutil.rmtree(backup, ignore_errors=True)
                shutil.copytree(step_dir, backup)
            self._mgr.delete(step)
            rewriting = True
        else:
            rewriting = False
        try:
            saved = self._mgr.save(
                step, lambda: _snapshot(state, clone=self._async),
                force=force, collective=state.sharding is not None)
        except BaseException:
            if rewriting:
                self._restore_backup(step, backup)
            raise
        if rewriting and not saved:
            # The forced rewrite was declined after the delete: put the
            # backup back, as on the exception path.
            self._restore_backup(step, backup)
        if saved:
            self._own_saves.add(step)
            if rewriting:
                self._mgr.wait_until_finished()
                if self._writer:
                    shutil.rmtree(backup, ignore_errors=True)
                # Same-path, often same-size files: the incremental remote
                # sync would keep the stale copy. Armed only now, so a
                # failed save leaves the remote copy as the fallback.
                self._force_synced.add(step)
            if self._async and self._remote is None:
                # The marker may exist only once the write is durable.
                self._pending_commit.add(step)
                logger.info("checkpoint save enqueued for step %d -> %s",
                            step, self._dir)
            else:
                # Mirrored remotes are durable only after upload.
                self._mgr.wait_until_finished()
                self._commit_collective(step, sync=True)
                logger.info("checkpoint saved at step %d -> %s",
                            step, self._remote or self._dir)
        return saved

    def _commit_collective(self, step, sync):
        """Commit ``step`` between two barriers: rank 0 writes the marker
        (and uploads a mirrored remote when ``sync``); the other ranks
        wait on both sides. Single-process: just the commit."""
        self._barrier()
        if self._writer:
            self._commit(step)
            if sync:
                self._sync_remote()
        self._barrier()
        # The durable line a relaunch resumes from, on every heartbeat.
        telemetry.set_gauge("checkpoint_last_step", int(step))

    def _commit(self, step):
        """Write the step's commit marker (manifest of file sizes) and GC
        markers whose steps ``max_to_keep`` rotated away."""
        step_dir = os.path.join(self._dir, str(step))
        if not os.path.isdir(step_dir):
            return
        with telemetry.span("checkpoint/commit", step=int(step)):
            t0 = time.monotonic()
            doc = {"step": int(step), "files": _step_manifest(step_dir)}
            marker = os.path.join(self._dir, _marker_name(step))
            # Per-writer tmp name: concurrent writers of one shared dir
            # must not consume each other's file mid-write.
            tmp = "{}.tmp.{}.{}".format(marker, os.getpid(),
                                        uuid.uuid4().hex[:8])
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, marker)  # atomic: a torn marker never validates
            telemetry.observe("checkpoint_commit_seconds",
                              time.monotonic() - t0)
        for name in os.listdir(self._dir):
            stale = _marker_step(name)
            if stale is not None and stale != int(step) and not os.path.isdir(
                    os.path.join(self._dir, str(stale))):
                try:
                    os.unlink(os.path.join(self._dir, name))
                except OSError:  # pragma: no cover - concurrent GC
                    pass

    def _flush_commits(self):
        """Make deferred async commits durable (marker after the write)."""
        if self._pending_commit:
            self._mgr.wait_until_finished()
            for step in sorted(self._pending_commit):
                self._commit_collective(step, sync=False)
            self._pending_commit.clear()

    def _restore_backup(self, step, backup):
        """Undo a force-rewrite's delete: put the backup back as the step
        dir, drop the backup, re-scan the steps."""
        if self._writer and os.path.isdir(backup):
            shutil.rmtree(os.path.join(self._dir, str(step)),
                          ignore_errors=True)
            shutil.copytree(backup, os.path.join(self._dir, str(step)))
            shutil.rmtree(backup, ignore_errors=True)
        self._mgr.reload()

    def _reconcile_mirror(self):
        """Make the (possibly reused) mirror reflect the remote: pull the
        remote tree and drop local entries the remote no longer has, so an
        earlier run's mirror cannot bring back steps the remote lost."""
        if fs_lib.exists(self._remote):
            fs_lib.get_tree(self._remote, self._dir)
            fs, base = fs_lib.get_fs(self._remote)
            remote_names = {
                e.rstrip("/").rsplit("/", 1)[-1]
                for e in fs.ls(base.rstrip("/"), detail=False)
            }
        else:
            remote_names = set()
        for name in os.listdir(self._dir):
            if name not in remote_names:
                path = os.path.join(self._dir, name)
                shutil.rmtree(path, ignore_errors=True)
                if os.path.isfile(path):
                    os.unlink(path)

    @contextlib.contextmanager
    def _mirror_lock(self):
        """Serialize mirror<->remote syncs across this host's processes."""
        import fcntl

        with open(self._dir + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)

    def _sync_remote(self):
        if self._remote is None or not self._writer:
            return
        with self._mirror_lock():
            # Incremental: a checkpoint file is written once, so (relative
            # path, size) identifies it and uploaded files are skipped.
            fs, base = fs_lib.get_fs(self._remote)
            base = base.rstrip("/")
            # Force-rewritten steps: purge the remote subtree first, or
            # its same-size files would survive the skip as stale.
            for step in sorted(self._force_synced):
                target = "{}/{}".format(base, step)
                if fs.exists(target):
                    fs.rm(target, recursive=True)
            self._force_synced.clear()
            have = {}
            if fs.exists(base):
                for info in fs.find(base, detail=True).values():
                    name = info["name"]
                    have[name[len(base):].lstrip("/")] = info.get("size")
            uploads = []
            for root, _, files in os.walk(self._dir):
                rel_root = os.path.relpath(root, self._dir)
                for fname in files:
                    rel = (fname if rel_root == "." else
                           "/".join(rel_root.split(os.sep) + [fname]))
                    uploads.append((os.path.join(root, fname), rel))
            # Step files before the top-level markers, so a reader of the
            # remote never sees a marker ahead of its files.
            uploads.sort(key=lambda item: "/" not in item[1])
            for local, rel in uploads:
                if have.get(rel) != os.path.getsize(local):
                    fs.put_file(local, base + "/" + rel)
            # Reflect max_to_keep deletions: drop remote entries gone here.
            keep = set(os.listdir(self._dir))
            for entry in fs.ls(base, detail=False):
                name = entry.rstrip("/").rsplit("/", 1)[-1]
                if name not in keep:
                    fs.rm(entry, recursive=True)

    def wait(self):
        """Block until in-flight async saves are durable (and committed)."""
        self._mgr.wait_until_finished()
        self._flush_commits()
        self._sync_remote()

    def latest_step(self):
        return self._mgr.latest_step()

    def latest_committed_step(self):
        """Newest step whose commit marker validates: the step the
        supervision layer relaunches from. None when nothing is
        committed."""
        self._flush_commits()
        return latest_committed_step(self._dir)

    def _restore_step(self):
        """The step :meth:`restore` should read: the latest committed step,
        skipping a newer partial save; marker-less trees fall back to the
        latest step so that restore-if-present keeps working for them."""
        step = self.latest_committed_step()
        latest = self._mgr.latest_step()
        if step is None:
            return latest
        if latest is not None and latest != step:
            logger.warning(
                "checkpoint step %s under %s is uncommitted or fails "
                "commit validation (partial write?); falling back to "
                "committed step %s", latest, self._dir, step,
            )
            self._discard_uncommitted_after(step)
        return step

    def _discard_uncommitted_after(self, step):
        """Delete the torn step dirs newer than the committed ``step``.

        Left in place they would poison the resumed run: a plain save at
        an existing step is declined, so the retrained step would never
        become durable and every later crash would resume from the same
        old step.
        """
        for stale in sorted(s for s in self._mgr.all_steps() if s > step):
            try:
                self._mgr.delete(stale)
                logger.warning(
                    "discarded uncommitted checkpoint step %s under %s",
                    stale, self._dir,
                )
            except Exception:
                logger.warning("could not discard uncommitted step %s",
                               stale, exc_info=True)
                continue
            marker = os.path.join(self._dir, _marker_name(stale))
            if self._writer and os.path.exists(marker):
                try:
                    os.unlink(marker)
                except OSError:  # pragma: no cover - concurrent GC
                    pass

    def _load(self, step, name, device):
        return torch.load(os.path.join(self._dir, str(step), ITEM, name),
                          map_location=device, weights_only=True)

    def restore(self, state):
        """Restore the latest committed step INTO ``state``: its parameters
        and buffers are overwritten in place (``copy_``), its optimizer
        takes the saved ``state_dict``, and the result is ``state`` at the
        restored step. With no checkpoint, ``state`` is returned unchanged.
        A partial newest save is skipped for the committed step before it.
        Only when nothing is committed and the newest (marker-less) step
        cannot be read does the run start fresh; a committed step that
        cannot be read raises."""
        with telemetry.span("checkpoint/restore") as sp:
            return self._restore(state, sp)

    def _restore(self, state, sp):
        step = self._restore_step()
        sp.set(step=step)
        if step is None:
            return state
        tensors = list(state.params.values())
        device = tensors[0].device if tensors else torch.device("cpu")
        try:
            params, model_state, opt_state = (
                self._load(step, name, device)
                for name in (PARAMS, MODEL_STATE, OPT_STATE))
        except Exception:
            if self.latest_committed_step() is None and \
                    step == self._mgr.latest_step():
                # A crash during the FIRST-ever save leaves a torn step and
                # nothing committed: starting fresh is the only restart
                # that can make progress.
                logger.warning(
                    "latest checkpoint step %s under %s is unreadable and "
                    "nothing is committed; starting fresh",
                    step, self._dir, exc_info=True,
                )
                return state
            raise
        if state.sharding is not None:
            params = state.sharding.local_state_dict(params)
            opt_state = _optimizer_tree(state, opt_state,
                                        state.sharding.local)
        with torch.no_grad():
            _copy_into(state.params, params, "params")
            _copy_into(state.model_state, model_state, "model_state")
        state.optimizer.load_state_dict(opt_state)
        logger.info("restored checkpoint step %d from %s", step, self._dir)
        return dataclasses.replace(state, step=step)

    def restore_variables(self):
        """The latest committed step's parameters and buffers as one flat
        CPU ``state_dict``, without a training state: the serving-side
        restore (``models.decoding.serving_variables`` and
        ``load_variables`` take it as it is). The optimizer file is never
        read."""
        step = self._restore_step()
        if step is None:
            raise FileNotFoundError("no checkpoint under {}".format(self._dir))
        variables = self._load(step, PARAMS, "cpu")
        variables.update(self._load(step, MODEL_STATE, "cpu"))
        logger.info("restored variables at step %d from %s", step, self._dir)
        return variables

    def close(self):
        """Finish in-flight saves and commit them."""
        self._mgr.wait_until_finished()
        self._flush_commits()


def _snapshot(state, clone):
    """The three objects of a step: parameters, buffers and optimizer state
    on the host. ``clone``: copy even CPU tensors (an async save must not
    see the live tensors' later updates). A sharded state's parameters and
    moments are gathered to full tensors first (collective)."""
    params, opt_state = dict(state.params), state.optimizer.state_dict()
    if state.sharding is not None:
        params = state.sharding.full_state_dict(params)
        opt_state = _optimizer_tree(state, opt_state, state.sharding.full)
    return (_host(params, clone),
            _host(dict(state.model_state), clone),
            _host(opt_state, clone))


def _optimizer_tree(state, opt_state, fn):
    """``opt_state`` with every per-parameter tensor shaped like its
    parameter's shard (or full tensor) passed through ``fn(name, t)``:
    the optimizer numbers parameters in ``state.params`` order."""
    names = list(state.params)
    out = dict(opt_state)
    out["state"] = {}
    for idx, per in opt_state["state"].items():
        name = names[idx]
        layout = state.sharding.layouts[name]
        shard = state.params[name]
        out["state"][idx] = {
            k: fn(name, v) if isinstance(v, torch.Tensor) and v.dim()
            and tuple(v.shape) in (tuple(shard.shape), layout.shape) else v
            for k, v in per.items()}
    return out
