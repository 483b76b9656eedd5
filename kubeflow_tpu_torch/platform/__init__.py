"""Platform shell (SURVEY.md §2a/§7 phase 8): multi-tenancy + deployment.

The port's copy of ``kubeflow_tpu/platform/__init__.py``: the same modules,
each a copy of the reference's at the same path, on GPU nodes.  A notebook
asks for ``nvidia.com/gpu`` cards where the reference's asks for TPU chips;
each module's docstring names the fields renamed for that.

  * ``api`` + ``controllers`` — Profile / Notebook / PodDefault CRDs and
    their reconcilers (namespace+RBAC+quota, StatefulSet+Service+culling,
    mutating pod injection);
  * ``kfam`` — access management (contributors as RoleBindings);
  * ``spawner`` — jupyter-web-app backend with an image/card form;
  * ``dashboard`` — central-dashboard aggregation API;
  * ``kfadm`` — kfctl-equivalent: KfDef apply wires pillars into a Cluster.
"""

from .controllers import install  # noqa: F401
from .kfadm import KfAdm, kfdef  # noqa: F401
