"""Training step: Adam on the raw parameters + per-Gaussian gradient stats,
as `tpu_gaussians.fit.step`.

One step renders every view, computes the loss stack, backpropagates
(through the K1/K2 autograd Function on the tiled path) and applies Adam
with the reference's hyperparameters (lr 0.02, betas (0.9, 0.999), eps
1e-8; fit_multiview_stub.py:262), whose update lr * m_hat / (sqrt(v_hat) +
eps) is optax's. The step updates the parameters in place, eagerly.

It also keeps `grad_norm_accum`, the running sum of |dL/d mean_i|_2, the
statistic that gradient-ranked cloning reads (densify.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import torch

from tpu_gaussians_torch.core.types import Camera, RenderConfig
from tpu_gaussians_torch.fit.loss import LossConfig, loss_fn
from tpu_gaussians_torch.models.gaussian_model import RawParams
from tpu_gaussians_torch.utils.profiling import annotate

Optimizer = Callable[[Dict[str, torch.Tensor]], torch.optim.Adam]


@dataclass
class TrainState:
    raw: RawParams               # trainable leaves are leaf tensors
    opt: torch.optim.Adam        # its first param group holds `means`
    grad_norm_accum: torch.Tensor  # (C,) running sum of |dL/d mean_i|_2
    grad_steps: torch.Tensor       # () int32


def make_optimizer(lr: float = 0.02) -> Optimizer:
    """A factory of Adam over a leaves dict, `means` in a group of its own
    so that its learning rate can be scaled (the trainer's positional lr
    decay). foreach is off on the CPU, where it is not the default path."""
    def tx(leaves: Dict[str, torch.Tensor]) -> torch.optim.Adam:
        groups = [{"params": [leaves["means"]]},
                  {"params": [t for k, t in leaves.items() if k != "means"]}]
        cpu = leaves["means"].device.type == "cpu"
        return torch.optim.Adam(groups, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                foreach=False if cpu else None)
    return tx


def init_state(raw: RawParams, tx: Optimizer) -> TrainState:
    """Fresh state: the trainable leaves become new leaf tensors that
    require grad (the caller's arrays are left untouched), fresh Adam."""
    raw = raw.with_trainable({k: t.detach().clone().requires_grad_(True)
                              for k, t in raw.trainable().items()})
    return TrainState(
        raw=raw, opt=tx(raw.trainable()),
        grad_norm_accum=torch.zeros((raw.capacity,), dtype=torch.float32,
                                    device=raw.device),
        grad_steps=torch.zeros((), dtype=torch.int32, device=raw.device))


def reset_optimizer(state: TrainState, tx: Optimizer) -> TrainState:
    """Fresh Adam state + cleared grad stats: the reference drops the
    optimizer state after every densify/prune (fit_multiview_stub.py:325)."""
    return TrainState(raw=state.raw, opt=tx(state.raw.trainable()),
                      grad_norm_accum=torch.zeros_like(state.grad_norm_accum),
                      grad_steps=torch.zeros_like(state.grad_steps))


def adam_update(state: TrainState, means_lr_scale: float = 1.0) -> None:
    """One Adam step from the leaves' .grad, in place. means_lr_scale
    multiplies the learning rate of `means` only: Adam normalises the
    gradient's scale away, so this scales the means update exactly as the
    JAX step scales it."""
    state.opt.param_groups[0]["lr"] = state.opt.defaults["lr"] * means_lr_scale
    state.opt.step()


def make_train_step(render_config: RenderConfig, loss_config: LossConfig,
                    has_masks: bool, has_depths: bool):
    """step(state, cameras, targets, masks, depths, means_lr_scale) ->
    (state, metrics), updating state in place; masks/depths are read only
    when has_masks / has_depths."""

    def step(state: TrainState, cameras: Camera, targets: torch.Tensor,
             masks: torch.Tensor, depths: torch.Tensor,
             means_lr_scale: float = 1.0
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with annotate("gs.fit.step", root=True):
            leaves = state.raw.trainable()
            state.opt.zero_grad(set_to_none=True)
            loss, metrics = loss_fn(state.raw, cameras, targets,
                                    masks if has_masks else None,
                                    depths if has_depths else None,
                                    render_config, loss_config)
            with annotate("gs.fit.backward"):
                loss.backward()
            for t in leaves.values():
                if t.grad is None:      # a leaf the loss did not reach
                    t.grad = torch.zeros_like(t)
            gnorm = torch.linalg.vector_norm(leaves["means"].grad, dim=1)
            adam_update(state, means_lr_scale)
            state.grad_norm_accum += gnorm
            state.grad_steps += 1
            metrics["grad_norm_mean"] = gnorm.mean()
            return state, metrics

    return step
