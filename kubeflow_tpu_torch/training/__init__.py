"""Training operator of the port: the job CRDs, their controllers and the SDK.

The port's copy of ``kubeflow_tpu/training``: the same eight job kinds,
reconciled onto the port's GPU nodes (``training/common.py`` says what
differs from the JAX operator)."""
