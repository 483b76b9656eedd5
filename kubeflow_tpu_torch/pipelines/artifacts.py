"""Artifact object store on the local filesystem, URIs ``mstore://bucket/key``.

A copy of ``kubeflow_tpu/pipelines/artifacts.py``: the same layout under
the same root, so a step run by the port's launcher and one run by the
reference's read and write the same objects.
"""

from __future__ import annotations

import os
import shutil

SCHEME = "mstore://"


class ObjectStore:
    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    # ------------------------------------------------------------------ uris

    def uri(self, bucket: str, key: str) -> str:
        return f"{SCHEME}{bucket}/{key}"

    def _path(self, uri: str) -> str:
        if not uri.startswith(SCHEME):
            raise ValueError(f"not an object-store uri: {uri!r}")
        rel = uri[len(SCHEME):]
        path = os.path.normpath(os.path.join(self.root, rel))
        # commonpath (not a prefix check) so "root-sibling" dirs can't pass
        if os.path.commonpath([path, self.root]) != self.root:
            raise ValueError(f"uri escapes the store root: {uri!r}")
        return path

    # ------------------------------------------------------------------- ops

    def put(self, uri: str, local_path: str) -> str:
        """Upload a file or directory to the store. Returns the uri."""
        dst = self._path(uri)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if os.path.isdir(local_path):
            if os.path.exists(dst):
                shutil.rmtree(dst)
            shutil.copytree(local_path, dst)
        else:
            shutil.copy2(local_path, dst)
        return uri

    def get(self, uri: str, local_path: str) -> str:
        """Download to a local path. Returns the local path."""
        src = self._path(uri)
        if not os.path.exists(src):
            raise FileNotFoundError(f"object not found: {uri}")
        os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
        if os.path.isdir(src):
            if os.path.exists(local_path):
                shutil.rmtree(local_path)
            shutil.copytree(src, local_path)
        else:
            shutil.copy2(src, local_path)
        return local_path

    def put_bytes(self, uri: str, data: bytes) -> str:
        dst = self._path(uri)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        with open(dst, "wb") as f:
            f.write(data)
        return uri

    def get_bytes(self, uri: str) -> bytes:
        src = self._path(uri)
        if not os.path.exists(src):
            raise FileNotFoundError(f"object not found: {uri}")
        with open(src, "rb") as f:
            return f.read()

    def get_head(self, uri: str, n: int) -> tuple:
        """First ``n`` bytes + the object's total size — preview without
        pulling a multi-GB artifact into memory (webui run pages)."""
        src = self._path(uri)
        if not os.path.isfile(src):
            raise FileNotFoundError(f"object not found (or not a file): {uri}")
        size = os.path.getsize(src)
        with open(src, "rb") as f:
            return f.read(n), size

    def exists(self, uri: str) -> bool:
        return os.path.exists(self._path(uri))
