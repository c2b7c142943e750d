"""The plain reference: a Qwen3 forward in plain PyTorch.

It imports neither JAX nor anything of the program (``tests/test_gpubench_isolation.py``)
and reads only the weights the benchmark drew (``gpubench/weights.py``).
"""
