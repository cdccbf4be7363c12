"""EPIK on PyTorch and CUDA: the port of ``epik_tpu`` to NVIDIA H100s.

The JAX package ``epik_tpu`` stays the reference; this package runs the same
placement with PyTorch around hand-written CUDA kernels (``kernels/csrc``).
It imports ``torch`` and never ``jax``, and nothing of ``epik_tpu``: the host
modules it needs (``core``, ``io``, ``engine.{types,pipeline,reference}``,
``native``, ``utils.progress``, ``tools.jplace_diff``) are its own copies of
the JAX package's numpy and pure-Python modules.

The slices ported so far: the single-device dense engine of ``epik place``
(the pair plane, the unpaired shifted f32 and int16 planes, the classic f32
and bf16 planes, the host-tokenize and device-lookup steps), the big-tree
posting-tile path with its CSR fallback, and the column-sharded big-tree path
over a device mesh (``parallel``). ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"
