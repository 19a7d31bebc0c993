"""adaqp_tpu_torch — the PyTorch/CUDA port of the distributed full-graph
GNN trainer with adaptive message quantization.

The JAX package beside it is the reference; this package keeps its module
names so that each counterpart is easy to find, and imports neither JAX nor
anything of the JAX package. Plain tensor code is PyTorch; each kernel the
reference wrote for its accelerator is a kernel written by hand for NVIDIA
Hopper (``csrc/``), built with ``nvcc`` at first use and bound with
``ctypes``. Every kernel wrapper runs the kernel on a CUDA tensor and its
plain PyTorch version on a CPU tensor.

Ported so far: training on K partitions, one ``torch.distributed`` rank
each — layouts, the strip bitmask SpMM kernel with its ELL straggler, the
exact-size ragged exchange with the quantize-pack and unpack-dequantize
kernels, the assigner, GCN/SAGE, the Trainer with checkpoint and resume
and its command line (``python -m adaqp_tpu_torch``); the native LDG
partitioner (``native/``) and its command line (``python -m
adaqp_tpu_torch.graph_partition``); the probes of ``scripts/`` that hold
kernels and the accuracy-parity experiment (``adaqp_tpu_torch.scripts``).
"""

__version__ = "0.1.0"

from . import common  # noqa: F401
