"""PixHomology in PyTorch with hand-written CUDA kernels for Hopper.

A port of the JAX/Pallas package ``repro`` (which stays as the reference
the port is tested against).  It imports ``torch`` and never ``jax`` or
anything of ``repro``.  The public facade is :mod:`repro_torch.ph`; its
entry points run on the CUDA device unless the caller asks for the CPU.
"""
