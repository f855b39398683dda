"""Each test process of the benchmark's CPU tests takes a few threads, so
that pytest-xdist's workers do not oversubscribe the cores."""

import torch

torch.set_num_threads(2)
