"""Debug aids, the counterparts of `tpu_gaussians.utils.debug`:

- `interpret_mode()`: under it every kernel wrapper runs its plain PyTorch
  twin, on CUDA tensors too, and launches nothing (the counterpart of
  Pallas' forced interpret mode: the same tiled algorithm, numerically
  checkable against the kernel). Outside it a wrapper launches its kernel
  on CUDA tensors or raises. Only an explicit caller enters it: no entry
  point does, and it is not a fallback.
- `assert_finite(tree, name)`: a NaN/Inf guard over tensors, arrays,
  numbers and nested dicts, lists, tuples and dataclasses (RawParams,
  Gaussians, TrainState; an optimizer by its state).
- `determinism_check(fn, *args)`: the same inputs must produce bitwise
  identical outputs across two runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import numbers
from typing import Iterator, List, Mapping

import numpy as np
import torch

from tpu_gaussians_torch.kernels import build


@contextlib.contextmanager
def interpret_mode() -> Iterator[None]:
    build.interpret_depth += 1
    try:
        yield
    finally:
        build.interpret_depth -= 1


def _leaves(tree) -> List[np.ndarray]:
    """The array leaves of `tree` as host numpy arrays, in a fixed order:
    dicts by sorted key (as jax.tree.leaves), dataclasses by field."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree.detach().cpu().numpy()]
    if isinstance(tree, (np.ndarray, numbers.Number)):
        return [np.asarray(tree)]
    if isinstance(tree, torch.optim.Optimizer):
        return _leaves(tree.state_dict()["state"])
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    if dataclasses.is_dataclass(tree):
        return [x for f in dataclasses.fields(tree)
                for x in _leaves(getattr(tree, f.name))]
    raise TypeError(f"no array leaves in a {type(tree).__name__}")


def assert_finite(tree, name: str = "value") -> None:
    for i, leaf in enumerate(_leaves(tree)):
        if not np.isfinite(leaf).all():
            raise FloatingPointError(f"non-finite values in {name}[leaf {i}]")


def determinism_check(fn, *args) -> bool:
    """Run fn twice; return True iff all outputs are bitwise identical."""
    a = _leaves(fn(*args))
    b = _leaves(fn(*args))
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and x.tobytes() == y.tobytes() for x, y in zip(a, b))
