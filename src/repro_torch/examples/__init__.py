"""Twins of the JAX package's ``examples/`` scripts, run as modules:

  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu
  PYTHONPATH=src python -m repro_torch.examples.allocator_showcase
  PYTHONPATH=src python -m repro_torch.examples.serve_paged --device cpu
  PYTHONPATH=src python -m repro_torch.examples.train_fault_tolerant \\
      --device cpu

Each does what its reference does and prints the same lines; each but
the host-only ``allocator_showcase`` takes ``--device`` (``cuda`` unless
``cpu`` is asked for) and writes what it writes under the checkout's
git-ignored ``build/`` directory.
"""

from pathlib import Path

import torch

#: the checkout's build directory, which git ignores
BUILD = Path(__file__).resolve().parents[3] / "build"


def need_device(device: str, who: str) -> None:
    """Raise unless ``device`` is the CPU or a card is present: an
    example never falls back to the CPU by itself."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass --device cpu to "
                           f"run on the CPU")
