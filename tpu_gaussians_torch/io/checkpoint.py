"""Checkpoint/resume of the full training state, the counterpart of
`tpu_gaussians.io.checkpoint` (which the reference lacks: it saves only a
final npz with no resume path, fit_multiview_stub.py:339-355).

A checkpoint is one `torch.save` file, `<directory>/<step>/state.pt`,
holding the raw params, the Adam `state_dict`, `grad_norm_accum` and
`grad_steps`, the step and the trainer's torch.Generator state (the
densify jitter's source). It is written under a temporary name and
renamed into place, so a crash never leaves a half checkpoint; the latest
`max_to_keep` are kept. The format is this package's own: the JAX
package's orbax checkpoints do not load here, nor these there. The final
npz export (reference schema) stays in io/npz.py.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from pathlib import Path
from typing import List, Optional, Tuple

import torch

from tpu_gaussians_torch.core.types import Device, resolve_device
from tpu_gaussians_torch.fit.step import Optimizer, TrainState, init_state
from tpu_gaussians_torch.models.gaussian_model import RawParams

STATE_FILE = "state.pt"


class Checkpointer:
    def __init__(self, directory: Path, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def steps(self) -> List[int]:
        """The steps of the complete checkpoints, ascending."""
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.name.isdigit() and (p / STATE_FILE).exists())

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState,
             generator: torch.Generator) -> None:
        payload = {
            "step": step,
            "raw": {f.name: None if getattr(state.raw, f.name) is None
                    else getattr(state.raw, f.name).detach()
                    for f in dataclasses.fields(RawParams)},
            "opt": state.opt.state_dict(),
            "grad_norm_accum": state.grad_norm_accum,
            "grad_steps": state.grad_steps,
            "generator": generator.get_state(),
        }
        final = self.directory / str(step)
        tmp = self.directory / f".tmp-{step}-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(payload, tmp / STATE_FILE)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old))

    def restore(self, tx: Optimizer, device: Device = "cuda"
                ) -> Tuple[int, TrainState, torch.Tensor]:
        """(step, state, generator state) of the latest checkpoint, the
        state's tensors on `device` and its Adam built by `tx`; load the
        generator state with torch.Generator.set_state."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        dev = resolve_device(device)
        payload = torch.load(self.directory / str(step) / STATE_FILE,
                             map_location=dev, weights_only=True)
        state = init_state(RawParams(**payload["raw"]), tx)
        opt = payload["opt"]
        for s in opt["state"].values():
            # Adam keeps its step counts on the CPU (not capturable); a
            # count on the card would cost a device sync per parameter.
            s["step"] = s["step"].cpu()
        state.opt.load_state_dict(opt)
        state.grad_norm_accum.copy_(payload["grad_norm_accum"])
        state.grad_steps.copy_(payload["grad_steps"])
        return step, state, payload["generator"].cpu()
