"""PyTorch/CUDA port of the ``repro`` package (the JAX reference).

The layout mirrors ``src/repro/`` module for module, so each counterpart is
found under the same path. Parameter trees keep the JAX layouts (dense ``w``
is ``(in, out)``) and the ``jax.flatten_util.ravel_pytree`` flat order, so a
flat update vector means the same thing in both packages.

Entry points run on CUDA unless the caller passes ``device="cpu"``; without
a card they raise instead of falling back (:func:`repro_torch.device.resolve`).
The five codec kernels of the ported paths and the flash-attention kernel
of the LM's prefill are hand-written CUDA for Hopper (``csrc/``), each
beside its plain PyTorch version (``kernels/ref.py``).
The federated round over a ``torch.distributed`` pod group
(``core/distributed.py``), the sharded server paths, the sharding rules
(``models/sharding.py``), the launchers (``launch/``) and the roofline on
the H100's constants (``roofline/``) complete the port of the JAX
package. This package never imports ``jax`` or anything of ``repro``.
"""
