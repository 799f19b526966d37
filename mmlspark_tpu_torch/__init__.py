"""mmlspark_tpu_torch — the PyTorch + CUDA port of ``mmlspark_tpu``.

The layout mirrors ``mmlspark_tpu/`` file for file, so each module's
counterpart sits at the same relative path. The port imports ``torch``
and numpy only: never ``jax`` and nothing of ``mmlspark_tpu``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :func:`mmlspark_tpu_torch.utils.device.resolve_device`).
Every hand-written kernel lives under ``csrc/`` beside a plain PyTorch
version of the same function, which runs for CPU tensors.
"""

__version__ = "0.1.0"
