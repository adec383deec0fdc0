"""The optimizer chain of the plain reference: NaN gradient entries zeroed,
the global norm clipped to ``clip`` (``g * clip / norm`` where norm >=
clip), AdamW (b1 0.9, b2 0.999, eps 1e-8, bias correction, decoupled decay
1e-6) at the linear OneCycle schedule's value at the step's count: optax's
``zero_nans -> clip_by_global_norm -> adamw`` as the recipe states it,
written from that definition."""

from __future__ import annotations

import torch


def onecycle(total: int, peak: float, pct_start: float = 0.01, div: float = 25.0,
             final_div: float = 1e4):
    """optax's ``linear_onecycle_schedule`` at pct_final 1: its boundaries
    are a dict, so the scale 1 / div at pct_final * total is replaced by
    1 / final_div at the same step ``total``: linear from peak / div up to
    peak at pct_start * total, then down to peak / final_div at total."""
    b1 = int(pct_start * total)
    v0, v1, v2 = peak / div, peak, peak / final_div

    def lr(count: int) -> float:
        if count < b1:
            return v0 + (v1 - v0) * count / b1
        if count < total:
            return v1 + (v2 - v1) * (count - b1) / (total - b1)
        return v2

    return lr


class AdamW:
    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: dict, lr, clip: float = 10.0, weight_decay: float = 1e-6):
        self.lr, self.clip, self.wd = lr, clip, weight_decay
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> dict:
        """Moves params in place; returns the gradients as the moment
        estimates took them (after the NaN zeroing and the clip)."""
        g = {k: torch.where(torch.isnan(grads[k]), torch.zeros_like(grads[k]), grads[k])
             for k in params}
        norm = torch.sqrt(sum(torch.sum(v.double() ** 2) for v in g.values())).float()
        if norm >= self.clip:
            g = {k: v / norm * self.clip for k, v in g.items()}
        lr = self.lr(self.count)
        self.count += 1
        c1, c2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for k, p in params.items():
            self.mu[k] = self.b1 * self.mu[k] + (1 - self.b1) * g[k]
            self.nu[k] = self.b2 * self.nu[k] + (1 - self.b2) * g[k] ** 2
            u = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + self.eps)
            p.sub_(lr * (u + self.wd * p))
        return g
