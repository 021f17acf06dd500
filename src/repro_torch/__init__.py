"""repro_torch — the FORMS serving stack in PyTorch, with hand-written CUDA
kernels for Hopper.

Mirrors the layout of the JAX package (``configs``, ``core``, ``forms``,
``kernels``, ``models``, ``serving``, ``launch``) so every module has a
counterpart of the same name.  Parameters are nested dicts of tensors keyed
like the JAX trees (``blocks/attn/wq``, stacked on a leading layer axis).
"""
