"""The benchmark of the PyTorch/CUDA port: ``python3 sketchbench/run.py``."""
