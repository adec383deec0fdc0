"""Training step: AdamW under the OneCycle schedule, with BA in the loop.

Port of ``dpvo_tpu/train/step.py``. The optimizer is optax's chain
``zero_nans -> clip_by_global_norm(clip) -> adamw(schedule, weight_decay
1e-6)`` written out in torch (``Optimizer``), value for value: NaN
gradient entries zeroed (others kept), the global norm clipped by
``t / norm * clip`` only where norm >= clip (no eps), Adam with eps 1e-8
and bias correction, the decay added to every trained leaf, the update
scaled by minus the schedule at the step's count. ``frozen`` leaves (the
encoders under ``--freeze_encoders``: optax's ``multi_transform`` with
``set_to_zero``) get a zero update, no Adam state and no decay, and the
global norm is taken over the trained leaves only.

Training over a (data, edge) mesh of processes (``make_train_step(...,
mesh=)``, ``apps/train.py --mesh``) splits each clip's unroll over the
edge axis and averages the gradients over the data axis, where the JAX
package shards the batch and annotates the unroll's edges and lets XLA
partition and reduce (``dpvo_tpu/train/step.py``).

Master parameters stay f32 (flax keeps its parameters f32 under
``dtype=bf16``); with ``MIXED_PRECISION`` the unroll runs on a
differentiable bf16 cast of them (``torch.func.functional_call``), so the
forward is the tracker's bf16 forward and the gradients land in f32.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable

import torch

from dpvo_tpu_torch.config import Config
from dpvo_tpu_torch.models.vonet import draw_inputs, vo_forward
from dpvo_tpu_torch.parallel.shard import all_sum, axis_rank, edge_split, local_clips
from dpvo_tpu_torch.train.loss import clip_loss


def linear_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             pct_final: float = 0.85, div_factor: float = 25.0,
                             final_div_factor: float = 1e4) -> Callable[[int], float]:
    """optax's linear OneCycle: a piecewise-linear interpolation between
    the accumulated values at its boundaries. The boundaries are a dict,
    so two that fall on the same step keep the later scale (with
    pct_final = 1 the schedule falls from the peak straight to
    peak / div / final_div at ``transition_steps``)."""
    if transition_steps <= 0:
        raise ValueError("a linear onecycle schedule needs transition_steps > 0")
    scales = {int(pct_start * transition_steps): div_factor,
              int(pct_final * transition_steps): 1.0 / div_factor,
              transition_steps: 1.0 / final_div_factor}
    bounds = [0] + sorted(scales)
    values = [peak_value / div_factor]
    for b in bounds[1:]:
        values.append(values[-1] * scales[b])

    def schedule(count: int) -> float:
        for k in range(len(bounds) - 1):
            if bounds[k] <= count < bounds[k + 1]:
                pct = (count - bounds[k]) / (bounds[k + 1] - bounds[k])
                return (values[k + 1] - values[k]) * pct + values[k]
        return values[-1]

    return schedule


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(t.to(torch.float32) ** 2) for t in tensors))


class Optimizer:
    """zero_nans -> clip_by_global_norm -> adamw, optax's arithmetic on
    flat dicts of tensors (see the module docstring). ``init(params)``
    gives the state; ``update(grads, state, params)`` returns (updates,
    state'); parameters then move by ``apply_updates``."""

    b1, b2, eps = 0.9, 0.999, 1e-8  # optax.adamw's defaults

    def __init__(self, schedule: Callable[[int], float], clip: float = 10.0,
                 weight_decay: float = 1e-6, frozen: Callable[[str], bool] = lambda name: False):
        self.schedule, self.clip, self.weight_decay, self.frozen = \
            schedule, clip, weight_decay, frozen

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        trained = [k for k in params if not self.frozen(k)]
        return {"count": 0,
                "mu": {k: torch.zeros_like(params[k]) for k in trained},
                "nu": {k: torch.zeros_like(params[k]) for k in trained}}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: Dict[str, torch.Tensor]):
        trained = list(state["mu"])
        g = {k: torch.where(torch.isnan(grads[k]), torch.zeros_like(grads[k]), grads[k])
             for k in trained}
        norm = global_norm(g.values())
        keep = norm < self.clip
        g = {k: torch.where(keep, v, v / norm * self.clip) for k, v in g.items()}
        count = state["count"] + 1
        dev = next(iter(params.values())).device
        c1 = 1.0 - torch.tensor(self.b1, dtype=torch.float32, device=dev) ** count
        c2 = 1.0 - torch.tensor(self.b2, dtype=torch.float32, device=dev) ** count
        lr = torch.tensor(-self.schedule(state["count"]), dtype=torch.float32, device=dev)
        mu, nu, updates = {}, {}, {}
        for k in trained:
            mu[k] = (1 - self.b1) * g[k] + self.b1 * state["mu"][k]
            nu[k] = (1 - self.b2) * g[k] ** 2 + self.b2 * state["nu"][k]
            u = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps)
            updates[k] = (u + self.weight_decay * params[k]) * lr
        for k in params:
            if k not in updates:
                updates[k] = torch.zeros_like(params[k])
        return updates, {"count": count, "mu": mu, "nu": nu}


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor], updates: Dict[str, torch.Tensor],
                  lr_scale: float = 1.0):
    """params += updates * lr_scale, in place (the networks' own tensors)."""
    for k, p in params.items():
        p.add_((updates[k] * lr_scale).to(p.dtype))


def make_optimizer(lr: float = 8e-5, total_steps: int = 240000, clip: float = 10.0,
                   freeze_encoders: bool = False):
    """AdamW + linear OneCycle (``dpvo_tpu/train/step.py:make_optimizer``);
    ``freeze_encoders`` zeroes the patchifier's updates as
    ``apps/train.py``'s ``multi_transform`` does. Returns (tx, schedule)."""
    schedule = linear_onecycle_schedule(total_steps, lr, pct_start=0.01, pct_final=1.0,
                                        div_factor=25.0, final_div_factor=10000.0)
    frozen = (lambda name: name.startswith("patchifier.")) if freeze_encoders \
        else (lambda name: False)
    return Optimizer(schedule, clip=clip, weight_decay=1e-6, frozen=frozen), schedule


def _batch_to(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _clip_draws(cfg: Config, batch, draws, STEPS: int, device):
    """One draw dict per clip: given as a list, or drawn from a generator
    for the configuration's centroid strategy."""
    B, F, H, W = batch["images"].shape[:4]
    if isinstance(draws, torch.Generator):
        return [draw_inputs(F, cfg.PATCHES_PER_FRAME, H // cfg.RES, W // cfg.RES, STEPS, draws,
                            device, cfg.CENTROID_SEL_STRAT) for _ in range(B)]
    if len(draws) != B:
        raise ValueError(f"one draw dict per clip: {len(draws)} for a batch of {B}")
    return [{k: v.to(device) for k, v in d.items()} for d in draws]


def batch_loss(nets, cfg: Config, batch, draws, STEPS: int, flow_weight: float,
               pose_weight: float, structure_only: bool = False, frozen_encoders: bool = False,
               remat: bool = True, params=None, mesh=None):
    """Mean clip loss and mean metrics over the batch (loops over its
    clips where JAX vmaps); with a mesh whose edge axis splits the unroll,
    this rank's share of them."""
    losses, mets = [], []
    for b, d in enumerate(draws):
        traj = vo_forward(nets, cfg, batch["images"][b], batch["poses"][b], batch["disps"][b],
                          batch["intrinsics"][b], d, STEPS=STEPS, structure_only=structure_only,
                          frozen_encoders=frozen_encoders, remat=remat, params=params,
                          mesh=mesh)
        loss, m = clip_loss(traj, batch["poses"][b].to(torch.float32), cfg.P,
                            flow_weight=flow_weight, pose_weight=pose_weight,
                            structure_only=structure_only, mesh=mesh)
        losses.append(loss)
        mets.append(m)
    metrics = {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
    return torch.stack(losses).mean(), metrics


def _forward_params(nets, cfg: Config):
    """The networks' f32 parameters, or (MIXED_PRECISION) a differentiable
    bf16 cast of them."""
    if not cfg.MIXED_PRECISION:
        return None
    return {k: p.to(torch.bfloat16) for k, p in nets.named_parameters()}


def _mesh_reduce(tensors: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Each tensor summed over the mesh's edge axis where it splits the
    unroll (each rank holds its share), then averaged over the data axis:
    one all_reduce each."""
    keys = list(tensors)
    xs = [tensors[k].to(torch.float32) for k in keys]
    if edge_split(mesh) is not None:
        xs = all_sum(mesh, "edge")(*xs)
    sums = all_sum(mesh, "data")(*xs)
    n = axis_rank(mesh, "data")[1]
    return {k: (x / n).to(tensors[k].dtype) for k, x in zip(keys, sums)}


def make_train_step(cfg: Config, tx: Optimizer, STEPS: int = 18, flow_weight=0.1,
                    pose_weight=10.0, frozen_encoders: bool = False, remat: bool = True,
                    mesh=None):
    """Returns train_step(nets, opt_state, batch, draws, structure_only,
    lr_scale) -> (nets, opt_state, metrics).

    nets: ``runtime/weights.Networks`` on the step's device, holding the
    f32 master parameters (updated in place). batch: dict(images
    [B,F,H,W,3] in [0, 255], poses [B,F,7] world-to-camera, disps
    [B,F,H,W], intrinsics [B,4]), numpy or torch. draws: a list of B draw
    dicts (``models/vonet.draw_inputs``) or a ``torch.Generator`` to draw
    them from. ``lr_scale`` multiplies the whole update, decay included.
    metrics: loss, gnorm (of the raw gradients), flow, tr, ro, px1 as
    device scalars. ``train_step.times`` holds the last step's wall
    seconds of forward, backward and optimizer when ``train_step.timed``
    is set (each phase then ends in a device synchronize).

    mesh: a (data, edge) mesh (``parallel.make_mesh``): every rank passes
    the same global batch and draws (or the same generator state) and
    replicated parameters. Each data rank takes its clips
    (``parallel.local_clips``); the ranks of one edge group split each of
    those clips' unroll by patch (``models/vonet.vo_forward``), each
    computing its share of the loss. The gradients and metrics are summed
    over the edge axis and averaged over the data axis before the
    optimizer, so every rank takes the single-process step of the global
    batch (its loss is the mean over clips), up to the order of the sums
    that cross ranks. The edge axis may not exceed PATCHES_PER_FRAME (a
    rank would own no patch)."""
    ne = axis_rank(mesh, "edge")[1]
    if ne > cfg.PATCHES_PER_FRAME:
        raise ValueError(f"make_train_step: an edge axis of {ne} ranks splits the unroll by "
                         f"patch, and a frame has {cfg.PATCHES_PER_FRAME} patches")

    def sync(dev):
        if train_step.timed and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    def train_step(nets, opt_state, batch, draws, structure_only: bool = False,
                   lr_scale: float = 1.0):
        params = dict(nets.named_parameters())
        dev = next(iter(params.values())).device
        batch = _batch_to(batch, dev)
        draws = _clip_draws(cfg, batch, draws, STEPS, dev)
        if mesh is not None:
            batch = local_clips(batch, mesh)
            draws = local_clips({"draws": draws}, mesh)["draws"]
        for p in params.values():
            p.grad = None
        t0 = sync(dev)
        loss, metrics = batch_loss(nets, cfg, batch, draws, STEPS, flow_weight, pose_weight,
                                   structure_only, frozen_encoders, remat,
                                   _forward_params(nets, cfg), mesh)
        t1 = sync(dev)
        loss.backward()
        t2 = sync(dev)
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in params.items()}
        if mesh is not None:
            grads = _mesh_reduce(grads, mesh)
        updates, opt_state = tx.update(grads, opt_state, {k: p.detach()
                                                          for k, p in params.items()})
        apply_updates({k: p.data for k, p in params.items()}, updates, lr_scale)
        t3 = sync(dev)
        train_step.times = dict(forward=t1 - t0, backward=t2 - t1, optimizer=t3 - t2)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        if mesh is not None:
            metrics = _mesh_reduce(metrics, mesh)
        metrics["gnorm"] = global_norm(grads.values())
        return nets, opt_state, metrics

    train_step.timed = False
    train_step.times = None
    return train_step


def make_val_step(cfg: Config, STEPS: int = 18, flow_weight=0.1, pose_weight=10.0):
    """val_step(nets, batch, draws) -> metrics: the forward-only loss and
    metrics on a held-out batch (no gradient, no checkpointing)."""

    @torch.no_grad()
    def val_step(nets, batch, draws):
        dev = next(nets.parameters()).device
        batch = _batch_to(batch, dev)
        draws = _clip_draws(cfg, batch, draws, STEPS, dev)
        loss, metrics = batch_loss(nets, cfg, batch, draws, STEPS, flow_weight, pose_weight,
                                   remat=False, params=_forward_params(nets, cfg))
        metrics["loss"] = loss
        return metrics

    return val_step
