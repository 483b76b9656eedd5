"""Katib of the port: Experiment, Suggestion and Trial, their controllers,
the suggestion algorithms and the observation-log store.

The port's copy of ``kubeflow_tpu/katib``; trials run as the port's
training jobs."""
