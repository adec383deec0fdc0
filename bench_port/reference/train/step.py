"""A training step of the plain reference: the mean clip loss over a
batch, its gradients by autograd, and the optimizer chain."""

from __future__ import annotations

import torch

from bench_port.reference.config import Config
from bench_port.reference.runtime.weights import load_networks
from bench_port.reference.train.loss import clip_loss
from bench_port.reference.train.optim import AdamW, onecycle
from bench_port.reference.train.vonet import fp8_products, vo_forward


class Trainer:
    """The reference's networks (f32, from ``weights``: an ``.npz`` path or
    a flat dict of the JAX package's keys) and its optimizer state at
    count 0. ``precision="fp8"``: the control (``vonet.vo_forward``)."""

    def __init__(self, cfg_dict: dict, weights, recipe: dict, device, precision: str = "f32"):
        self.cfg = Config(**cfg_dict)
        self.recipe, self.precision = recipe, precision
        self.nets = load_networks(self.cfg, weights).to(device)
        if precision == "fp8":
            fp8_products(self.nets)
        self.params = dict(self.nets.named_parameters())
        self.opt = AdamW({k: p.detach() for k, p in self.params.items()},
                         onecycle(recipe["total_steps"], recipe["lr"]), recipe["clip"],
                         recipe["weight_decay"])

    def step(self, batch: dict, draws: list):
        """(loss, the gradients as the optimizer took them) of one step on
        a batch (numpy, as the batcher gives it) and its draws."""
        dev = next(iter(self.params.values())).device
        b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        for p in self.params.values():
            p.grad = None
        losses = []
        for i, d in enumerate(draws):
            traj = vo_forward(self.nets, self.cfg, b["images"][i], b["poses"][i], b["disps"][i],
                              b["intrinsics"][i], {k: v.to(dev) for k, v in d.items()},
                              STEPS=self.recipe["unroll"], precision=self.precision)
            losses.append(clip_loss(traj, b["poses"][i].to(torch.float32), self.cfg.P,
                                    self.recipe["flow_weight"], self.recipe["pose_weight"]))
        loss = torch.stack(losses).mean()
        loss.backward()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in self.params.items()}
        with torch.no_grad():
            g = self.opt.step({k: p.data for k, p in self.params.items()}, grads)
        return float(loss.detach()), g
