"""The benchmark of the PyTorch/CUDA port (`gmmloc_tpu_torch`): see
README.md and `run.py`."""
