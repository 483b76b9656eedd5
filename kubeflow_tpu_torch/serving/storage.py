"""Storage initializer: fetch a model from a storage URI to a local dir.

A copy of ``kubeflow_tpu/serving/storage.py`` (the port imports nothing of
the JAX package): the same ``download`` dispatch over ``file://``,
``pvc://`` and the mirrored ``gs://``/``s3://``/``hf://`` schemes, which
``agent.ModelPuller`` calls and the InferenceService's storage-initializer
init container runs (``python -m kubeflow_tpu_torch.serving.storage <uri>
<dest>``, serving/controllers.py).

Remote schemes resolve ONLY through a local mirror: set
``KSERVE_STORAGE_MIRROR=/path`` and ``gs://bucket/x`` maps to
``$KSERVE_STORAGE_MIRROR/gs/bucket/x`` (same for s3/hf); there is no network
fetch.  ``file://`` and ``pvc://`` are served directly.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

MIRROR_ENV = "KSERVE_STORAGE_MIRROR"
PVC_ROOT_ENV = "KSERVE_PVC_ROOT"
# the simulator's /mnt/models: the JAX package's /tmp/kubeflow-tpu-models,
# under the process's temporary directory
MOUNT_PATH = os.path.join(tempfile.gettempdir(), "kubeflow-tpu-models")


class StorageError(RuntimeError):
    pass


def _copy_tree_or_file(src: str, dest: str) -> None:
    if not os.path.exists(src):
        raise StorageError(f"source path does not exist: {src}")
    os.makedirs(dest, exist_ok=True)
    if os.path.isdir(src):
        shutil.copytree(src, dest, dirs_exist_ok=True)
    else:
        shutil.copy2(src, os.path.join(dest, os.path.basename(src)))


def download(uri: str, dest: str) -> str:
    """Materialize `uri` under directory `dest`; returns dest."""
    if "://" not in uri:
        raise StorageError(f"not a storage URI: {uri!r}")
    scheme, rest = uri.split("://", 1)
    rest = rest.rstrip("/")
    if scheme == "file":
        _copy_tree_or_file(rest if rest.startswith("/") else "/" + rest, dest)
    elif scheme == "pvc":
        # pvc://<claim-name>/<path> — claims live under KSERVE_PVC_ROOT/<claim>
        root = os.environ.get(PVC_ROOT_ENV)
        if not root:
            raise StorageError(f"pvc:// needs {PVC_ROOT_ENV} set")
        claim, _, path = rest.partition("/")
        _copy_tree_or_file(os.path.join(root, claim, path), dest)
    elif scheme in ("gs", "s3", "hf"):
        mirror = os.environ.get(MIRROR_ENV)
        if not mirror:
            raise StorageError(
                f"{scheme}:// has no network egress here; set {MIRROR_ENV} to a local mirror root"
            )
        _copy_tree_or_file(os.path.join(mirror, scheme, rest), dest)
    else:
        raise StorageError(f"unsupported storage scheme: {scheme}://")
    return dest


def main(argv: list[str]) -> int:
    if len(argv) != 3:
        print("usage: python -m kubeflow_tpu_torch.serving.storage <uri> <dest>", file=sys.stderr)
        return 2
    try:
        download(argv[1], argv[2])
    except StorageError as e:
        print(f"storage-initializer: {e}", file=sys.stderr)
        return 1
    print(f"storage-initializer: {argv[1]} -> {argv[2]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
