"""adaqp_tpu_torch — the PyTorch/CUDA port of the distributed full-graph
GNN trainer with adaptive message quantization.

The JAX package beside it is the reference; this package keeps its module
names so that each counterpart is easy to find, and imports neither JAX nor
anything of the JAX package. Plain tensor code is PyTorch; each kernel the
reference wrote for its accelerator is a kernel written by hand for NVIDIA
Hopper (``csrc/``), built with ``nvcc`` at first use and bound with
``ctypes``. Every kernel wrapper runs the kernel on a CUDA tensor and its
plain PyTorch version on a CPU tensor.

Ported so far: the single-partition (K=1) training path — layouts, the
strip bitmask SpMM kernel with its ELL straggler, GCN/SAGE, the Trainer.
"""

__version__ = "0.1.0"

from . import common  # noqa: F401
