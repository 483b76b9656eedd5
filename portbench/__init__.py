"""The benchmark of the PyTorch and CUDA port (``kubeflow_tpu_torch``) on one
NVIDIA H100: ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (``run.py``).  ``spec.py`` says where each
configuration, mix, cell and metric lives."""
