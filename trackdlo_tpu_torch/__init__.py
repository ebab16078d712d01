"""trackdlo_tpu_torch: the PyTorch/CUDA port of the trackdlo_tpu tracker.

The JAX package ``trackdlo_tpu`` is the reference this package is held
against. Module names mirror it so each counterpart is easy to find:

- :mod:`trackdlo_tpu_torch.ops` — per-frame numerics (EM, visibility, priors,
  preprocessing) with a hand-written Hopper kernel beside a plain PyTorch
  version for each former Pallas kernel on the main path;
- :mod:`trackdlo_tpu_torch.models.trackdlo` — ``Tracker``;
  :mod:`trackdlo_tpu_torch.models.multi` — ``MultiTracker``;
- :mod:`trackdlo_tpu_torch.parallel` — the batched multi-stream step;
- :mod:`trackdlo_tpu_torch.convert` — state exchange with the JAX package;
- ``csrc/`` — the CUDA C++ sources, built at first use by ``_build``.

The package keeps its own copies of the numpy-only modules it needs
(``config``, ``io.sequence``, ``dlo_init`` and the float64 ``oracle``), with
only their import paths changed. It imports neither ``jax`` nor anything of
``trackdlo_tpu``. Its entry points run on the CUDA card unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
