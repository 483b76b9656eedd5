"""Pipelines SDK of the port: the DSL and the compiler.

Counterpart of ``kubeflow_tpu/pipelines/__init__.py``, reduced to what a
pipeline author imports: ``dsl`` and ``Compiler``, copies of the JAX-free
reference modules, plus ``artifacts`` and ``launcher_main``, which run one
compiled step in its pod.  ``Client``, ``install`` and the controllers are
the control plane, which stays the reference's: it takes the IR dict this
compiler emits as it is.
"""

from . import dsl  # noqa: F401
from .compiler import Compiler  # noqa: F401
