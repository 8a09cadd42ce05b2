"""portbench: the benchmark of kube_batch_tpu_torch, the PyTorch and CUDA
port of the scheduler, on an NVIDIA card.  ``python3 -m portbench.run``
runs one cell of BENCHMARK.json once; see run.py."""
