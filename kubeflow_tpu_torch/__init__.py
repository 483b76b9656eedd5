"""PyTorch/CUDA port of the platform's compute (H100 twin of ``kubeflow_tpu``)."""
