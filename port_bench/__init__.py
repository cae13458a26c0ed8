"""The PyTorch and CUDA port's benchmark: ``python3 port_bench/run.py --help``."""
