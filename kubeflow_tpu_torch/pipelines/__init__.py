"""Pipelines (KFP-equivalent) of the port: DSL, compiler, DAG executor,
metadata, client.

Counterpart of ``kubeflow_tpu/pipelines/__init__.py``, with the same layers,
each a copy of the reference module at the same path:
  * ``dsl`` + ``compiler`` — @component/@pipeline → IR JSON (the reference's
    IR);
  * ``metadata`` — MLMD-equivalent native store (``metadata_core.cc``, a
    byte copy of the reference's, WAL-backed);
  * ``artifacts`` — the local object store (``mstore://``);
  * ``workflow`` — the DAG controller + embedded v2 driver and the step pod,
    which runs ``launcher_main`` of this package; a step gets a card from an
    ``nvidia.com/gpu`` entry in its task's resources, and a ``tpu`` task
    stays Pending;
  * ``schedule`` — ScheduledWorkflow (cron/interval recurring runs);
  * ``service`` + ``client`` + ``persistence`` — the API server, the
    kfp.Client equivalent and the persistence agent.
"""

from . import dsl  # noqa: F401
from .client import Client, install  # noqa: F401
from .compiler import Compiler  # noqa: F401
