"""ChaoRec on PyTorch and CUDA: the port of ``chaorec_tpu`` to one NVIDIA H100.

The JAX package ``chaorec_tpu`` is the reference and stays beside this one.
Each module here keeps the path and the public names of its JAX
counterpart (``chaorec_tpu/ops/diffusion.py`` -> ``ops/diffusion.py``), so
the two are easy to hold side by side. Inside, the code is plain PyTorch:
functions on tensors, params as a dict of tensors, an explicit ``device``
wherever a tensor is made, explicit ``torch.Generator``s for randomness, and
Python loops where the JAX package used ``lax.scan``.

The package never imports ``jax`` or ``chaorec_tpu``; only the parity tests
import both. The TPU's Pallas kernels become CUDA C++ kernels under
``csrc/``, built with ``nvcc`` at first use (``kernels.py``); each keeps a
plain PyTorch version beside it, which CPU tensors take.

Ported so far: the serving path of CF_Diff (export and serve) and the
embeddings Recommender. See ROADMAP.md for what remains.
"""

import os

# The trainer runs in PyTorch's deterministic mode (train/loop.py:
# deterministic_mode), under which a cuBLAS product raises unless this is
# set before the process's first cuBLAS call.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

__version__ = "0.1.0"
