"""One torch intra-op thread in each test process.

The port's CPU tests run the kernels' plain versions on small tensors,
under pytest-xdist with six workers on a machine of about as many cores.
With torch's default pool (one thread per core) in every worker, each
rounding op (torch.floor, trunc, ...) and each small matmul waits for
threads that the other workers keep busy: 10-20 ms per call instead of a
few microseconds, measured on a [184, 16] float32 tensor.  One thread per
process gives every value the same bits and removes that wait.  Every
tests/test_torch_*.py imports this module first.
"""
import torch

torch.set_num_threads(1)
