"""trackdlo_tpu_torch: the PyTorch/CUDA port of the trackdlo_tpu tracker.

The JAX package ``trackdlo_tpu`` is the reference this package is held
against. Module names mirror it so each counterpart is easy to find:

- :mod:`trackdlo_tpu_torch.ops` — per-frame numerics (EM, visibility, priors,
  preprocessing) with a hand-written Hopper kernel beside a plain PyTorch
  version for each former Pallas kernel on the main path;
- :mod:`trackdlo_tpu_torch.models.trackdlo` — ``Tracker``;
- :mod:`trackdlo_tpu_torch.convert` — state exchange with the JAX package;
- ``csrc/`` — the CUDA C++ sources, built at first use by ``_build``.

The JAX-free parts of ``trackdlo_tpu`` (``config``, ``io.sequence``,
``oracle``, ``dlo_init``) are shared, not copied. This package never imports
``jax``.
"""

__version__ = "0.1.0"
