"""Scheme-aware path normalization.

The analog of the reference's ``TFNode.hdfs_path``
(``tensorflowonspark/TFNode.py:25-49``): turn user-supplied
paths into fully-qualified URIs against the cluster's default filesystem so
every host resolves checkpoints/exports identically. ``gs://`` is among the
recognized schemes.
"""

import getpass
import logging
import os
import re

logger = logging.getLogger(__name__)

# Any fsspec-style scheme passes through (gs, hdfs, s3, memory, ...).
_SCHEME_RE = re.compile(r"^[A-Za-z][A-Za-z0-9+.-]*://")


def absolute_path(path, default_fs="file://", working_dir=None):
    """Return a fully-qualified URI for ``path``.

    * already-schemed paths pass through untouched;
    * absolute paths are qualified against ``default_fs``;
    * relative paths resolve under the working dir for local filesystems and
      under ``/user/<user>/`` for distributed ones (matching the reference's
      HDFS convention).
    """
    if _SCHEME_RE.match(path):
        return path

    working_dir = working_dir or os.getcwd()
    if default_fs.startswith("file://") or default_fs == "file:///":
        if os.path.isabs(path):
            return "file://" + path
        return "file://" + os.path.join(working_dir, path)

    fs = default_fs.rstrip("/")
    if os.path.isabs(path):
        return fs + path
    return "{}/user/{}/{}".format(fs, getpass.getuser(), path)


def strip_scheme(path):
    """Local filesystem path for a ``file://`` URI (identity otherwise)."""
    if path.startswith("file://"):
        return path[len("file://"):]
    return path
