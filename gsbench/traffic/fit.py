"""Fit traffic: training steps of tpu_gaussians_torch's train step, driven
the way `fit.trainer.fit` drives it, on a pool of seeded orbit views.

Set-up builds one training state (the configuration's scene as raw
parameters, Adam), resolves the route as the trainer does from the
configuration's footprint and capacity (`render_mode` auto) and refuses
any but the sorted route, the one the reference implements, measures the
pair budget with `ops.sorted.auto_pair_k` over the pool as the trainer
does, and runs the first `checked_steps`
steps through the window's own call, each on views of its own, then
`warm_steps` more. The window dispatches steps back to back, each on the
next group of `views_per_step` pool views, keeps each step's metrics on
the device as the trainer does, and ends in a synchronize. Densify, prune
and opacity reset do not run, so N stays fixed.

The check runs the plain reference's first steps from the same initial
parameters and views and compares the first step's loss, its gradient
(from Adam's first moment after one step) and the parameters' change over
the checked steps, leaf by leaf.
"""

from __future__ import annotations

import gc
import statistics
import time
from pathlib import Path

import torch

from gsbench import counts, scene
from gsbench import trace as tr_mod
from gsbench.reference import render as R
from gsbench.reference import train as T

def inputs(cell: dict, seed: int, device):
    """(raw0 leaves, views (P, 4, 4), proj (4, 4), targets (P, H, W, 3),
    masks (P, H, W)) made from the seed."""
    cfg, tr = cell["config"], cell["traffic"]
    w, h, pool = tr["width"], tr["height"], tr["view_pool"]
    g = scene.make_scene(cfg, seed, device)
    y = g["scales"] - 1e-3
    raw0 = {"means": g["means"],
            "scales_raw": (y + torch.log(-torch.expm1(-y))).contiguous(),
            "opacities_raw": torch.logit(g["opacities"]).contiguous(),
            "sh_raw": g["sh"]}
    if "quats" in g:
        raw0["quats_raw"] = g["quats"]
    poses = scene.orbit_path(tr["cameras"], seed, "fit_views", pool)
    views = torch.stack([R.look_at(R.orbit_eye(*p), device) for p in poses])
    proj = R.perspective(tr["cameras"]["fovy"], w / h, 0.01, 100.0, device)
    targets = scene.smooth_fields(pool, h, w, 3, seed, "targets", device)
    masks = (scene.smooth_fields(pool, h, w, 1, seed, "masks", device)[..., 0]
             > 0.5).float()
    return raw0, views, proj, targets, masks


def reference_budget(raw0, views, proj, width, height, cfg) -> int:
    """The reference's own pair budget over the pool at raw0."""
    with torch.no_grad():
        g = T.activate(raw0)
        most = max(int(R.full_box_tiles(R.screen_stage(
            g, v, proj, width, height, cfg), width, height).max())
            for v in views)
    return R.pair_budget(most, raw0["means"].shape[0])


def gaps(prog: dict, ref: dict, keys) -> float:
    """Worst leaf's |‖prog‖ - ‖ref‖| over the larger of the reference's
    norm of that leaf and of the median leaf."""
    norms = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    med = statistics.median(norms.values())
    return max(abs(float(torch.linalg.vector_norm(prog[k].double()))
                   - norms[k]) / max(norms[k], med, 1e-30) for k in keys)


class Run:
    def __init__(self, cell: dict, seed: int, device, tmpdir: Path, log):
        from tpu_gaussians_torch.core.types import Camera, RenderConfig
        from tpu_gaussians_torch.fit.loss import LossConfig
        from tpu_gaussians_torch.fit.step import (
            init_state, make_optimizer, make_train_step)
        from tpu_gaussians_torch.fit.trainer import METRIC_KEYS
        from tpu_gaussians_torch.kernels import build
        from tpu_gaussians_torch.models.gaussian_model import (
            RawParams, activate)
        from tpu_gaussians_torch.ops.sorted import auto_pair_k
        from tpu_gaussians_torch.utils.config import (
            FitConfig, resolve_render_mode)

        self.cell, self.seed, self.device, self.tmpdir = cell, seed, device, tmpdir
        self.log = log
        tr = self.tr = cell["traffic"]
        cfg = cell["config"]
        w, h, v = tr["width"], tr["height"], tr["views_per_step"]
        if device.type == "cuda":
            prebuilt = {k: build.library_path(k).exists() for k in tr["kernels"]}
        raw0, views, proj, targets, masks = inputs(cell, seed, device)
        self.raw0 = {k: t.clone() for k, t in raw0.items()}
        self.views, self.proj, self.targets, self.masks = views, proj, targets, masks
        pool = views.shape[0]
        self.groups = [list(range(j * v, (j + 1) * v)) for j in range(pool // v)]
        projs = proj.expand(v, 4, 4).contiguous()
        self.batches = [(Camera(view=views[idx].contiguous(), proj=projs),
                         targets[idx].contiguous(), masks[idx].contiguous())
                        for idx in self.groups]
        self.zeros = torch.zeros((v, h, w), device=device)

        n = cfg["num_gaussians"]
        raw = RawParams(alive=torch.ones((n,), device=device),
                        **{k: t.clone() for k, t in raw0.items()})
        mode = resolve_render_mode(FitConfig(footprint=cfg["footprint"]),
                                   cfg["capacity"])
        if mode != "sorted":
            raise ValueError(f"the trainer takes the {mode!r} route for "
                             f"{cfg['name']}; the reference implements the "
                             "sorted route only")
        self.cap, self.exit_t = R.tile_capacity(n), R.EXACT_EXIT_T
        self.pair_k = auto_pair_k(activate(raw), views,
                                  proj.expand(pool, 4, 4), w, h,
                                  footprint=cfg["footprint"])
        log(f"route {mode}, pair budget {self.pair_k} (auto_pair_k)")
        render_config = RenderConfig(
            width=w, height=h, impl="auto", footprint=cfg["footprint"],
            mode=mode, sorted_pair_k=self.pair_k, return_aux=True)
        loss_config = LossConfig(**tr["loss"])
        self.state = init_state(raw, make_optimizer(tr["lr"]))
        self.step_fn = make_train_step(render_config, loss_config,
                                       has_masks=True, has_depths=False)
        self.keys = METRIC_KEYS
        self.i = 0
        self.rows = []

        # The checked steps: losses, the first gradient as Adam holds it,
        # the parameters after the last of them.
        losses = []
        for s in range(tr["checked_steps"]):
            metrics = self.step()
            losses.append(metrics["loss"])
            if s == 0:
                leaves = self.state.raw.trainable()
                b1 = self.state.opt.defaults["betas"][0]
                self.grad1 = {k: self.state.opt.state.get(leaves[k], {}).get(
                    "exp_avg", torch.zeros_like(leaves[k])).clone() / (1 - b1)
                    for k in T.leaves(self.raw0)}
        self.params_checked = {k: t.detach().clone() for k, t in
                               self.state.raw.trainable().items()}
        self.losses = [float(x) for x in losses]
        for _ in range(tr["warm_steps"]):
            self.step()
        if device.type == "cuda":
            torch.cuda.synchronize()
            built = sorted(k for k, pre in prebuilt.items() if not pre)
            log("kernels: " + ("every library loaded from "
                               "tpu_gaussians_torch/_build/" if not built
                               and not build.logs else
                               f"built this run: {sorted(build.logs)}"))
        self.attempted = self.failed = 0

    def step(self):
        cams, tgt, msk = self.batches[self.i % len(self.batches)]
        self.i += 1
        self.state, metrics = self.step_fn(self.state, cams, tgt, msk,
                                           self.zeros, means_lr_scale=1.0)
        self.rows.append(torch.stack([metrics[k].to(torch.float32)
                                      for k in self.keys]))
        return metrics

    def _finish(self, first: int) -> None:
        hist = torch.stack(self.rows[first:]).cpu()
        self.attempted += hist.shape[0]
        self.failed += int((~torch.isfinite(hist[:, 0])).sum())

    def window(self, seconds: float) -> dict:
        tr = self.tr
        first = len(self.rows)
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (
            lambda: None)
        sync()
        t0 = time.perf_counter()
        end = t0 + seconds
        steps = 0
        while time.perf_counter() < end:
            self.step()
            steps += 1
        sync()
        wall = time.perf_counter() - t0
        self._finish(first)
        pixels = steps * tr["views_per_step"] * tr["width"] * tr["height"]
        self.log(f"window: {steps} steps in {wall:.4f} s")
        return {"fit_mpix_s": {"value": pixels / wall / 1e6,
                               "unit": "Mpix/s"}}

    def traced(self) -> dict:
        tr = self.tr
        facts = {"kind": "fit"}
        snaps = {}
        # (a) the card alone, the host at its own pace: idle share, mfu;
        # (b) host operators and Python frames: host operations, and which
        # layer launched each kernel.
        for name, calls, stack in (("a", tr["trace_steps"], False),
                                   ("b", tr["trace_steps_stack"], True)):
            first = len(self.rows)
            snaps[name] = []

            def run(calls=calls, name=name):
                for _ in range(calls):
                    with torch.profiler.record_function(tr_mod.EXCLUDE):
                        snaps[name].append(
                            ({k: t.detach().clone() for k, t in
                              self.state.raw.trainable().items()},
                             self.groups[self.i % len(self.groups)]))
                    self.step()
                return calls

            facts[name] = tr_mod.profile_window(run, stack, tr["trace_pad_s"],
                                                self.tmpdir, host=stack)
            self._finish(first)
        self.snaps = snaps
        self.facts = facts
        return facts

    def release(self) -> None:
        self.state = self.step_fn = self.batches = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def count_work(self) -> None:
        """The work of each traced step, counted by the reference at the
        parameters the step started from."""
        tr, cfg = self.tr, self.cell["config"]
        w, h = tr["width"], tr["height"]
        self.ref_budget()
        works = {}
        for name, snaps in self.snaps.items():
            fwd = bwd = step = counts.Work()
            for raw, idx in snaps:
                pairs_all = listed_all = 0
                with torch.no_grad():
                    g = T.activate(raw)
                    for vi in idx:
                        st = R.screen_stage(g, self.views[vi], self.proj, w,
                                            h, cfg)
                        slots, cnt = R.tile_lists(st, w, h, self.ref_k,
                                                  self.cap)
                        _, pairs = R.composite_frame(
                            R.rows_table(st), slots, cnt, w, h,
                            exit_t=self.exit_t)
                        pairs_all += pairs
                        listed_all += int(cnt.sum())
                fwd = fwd + counts.composite_fwd(pairs_all, listed_all,
                                                 w * h * len(idx),
                                                 cfg["footprint"])
                bwd = bwd + counts.composite_bwd(pairs_all, listed_all,
                                                 w * h * len(idx),
                                                 cfg["footprint"])
                step = step + counts.train_step(pairs_all, listed_all, w * h,
                                                len(idx), cfg)
            works[name] = {"composite_fwd": fwd, "composite_bwd": bwd,
                           "step": step}
        self.facts["work_a"] = works["a"]
        self.facts["work_b"] = works["b"]

    def outputs(self):
        return self.losses, self.grad1, self.params_checked

    def reference_outputs(self, tf32: bool = False):
        """The plain reference's (losses, first gradient, parameters after
        the checked steps); tf32 runs it with TF32 products, the control."""
        tr = self.tr
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        self.ref_budget()
        try:
            return self.reference()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def ref_budget(self) -> int:
        if getattr(self, "ref_k", None) is None:
            self.ref_k = reference_budget(self.raw0, self.views, self.proj,
                                          self.tr["width"], self.tr["height"],
                                          self.cell["config"])
        return self.ref_k

    def compare(self, prog, ref) -> list:
        return compare(*prog, *ref, self.raw0, self.cell["limits"])

    def check(self):
        return self.compare(self.outputs(), self.reference_outputs())

    def reference(self):
        tr = self.tr
        groups = [self.groups[s % len(self.groups)]
                  for s in range(tr["checked_steps"])]
        batches = [(self.views[idx], self.proj.expand(len(idx), 4, 4),
                    self.targets[idx], self.masks[idx]) for idx in groups]
        spec = {"width": tr["width"], "height": tr["height"],
                "loss": tr["loss"], "background": [0.0, 0.0, 0.0],
                "exit_t": self.exit_t, "lr": tr["lr"],
                "config": self.cell["config"]}
        return T.reference_steps(self.raw0, batches, spec, self.ref_k,
                                 self.cap)


def compare(p_losses, p_grad1, p_params, r_losses, r_grad1, r_params, raw0,
            lim) -> list:
    """[(name, value, limit)]: the first step's relative loss gap, the
    worst leaf's first-gradient gap and parameter-change gap. Leaves whose
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone under Adam and are left out of the change. The later
    steps' losses are not compared: Adam turns the rounding of gradients
    near its eps into whole steps of some parameters, which the loss of
    the next step shows (PERF.md, the fit cell's limits)."""
    loss_gap = abs(p_losses[0] - r_losses[0]) / max(abs(r_losses[0]), 1e-30)
    names = T.leaves(raw0)
    grad_gap = gaps(p_grad1, r_grad1, names)
    gnorm = {k: float(torch.linalg.vector_norm(r_grad1[k])) for k in names}
    med = statistics.median(gnorm.values())
    moved = [k for k in names if gnorm[k] >= 1e-3 * med]
    p_change = {k: p_params[k] - raw0[k] for k in moved}
    r_change = {k: r_params[k] - raw0[k] for k in moved}
    change_gap = gaps(p_change, r_change, moved)
    return [("loss_gap", loss_gap, lim["loss_gap"]),
            ("grad_gap", grad_gap, lim["grad_gap"]),
            ("change_gap", change_gap, lim["change_gap"])]


def step_loss_gaps(prog, ref) -> list:
    """Every checked step's relative loss gap (a reading, not compared)."""
    return [abs(p - r) / abs(r) for p, r in zip(prog[0], ref[0])]
