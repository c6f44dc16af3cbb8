"""AdamW with decoupled weight decay, global-norm clipping, LR schedules.
The port of `repro.optim.adamw`: the same clip, bias correction and
weight-decay order, in f32.

Functional, as in the JAX package: `apply_updates` returns new parameter
and moment trees and leaves its arguments unchanged.  Trees are nested
dicts of tensors (`repro_torch._tree`); the moments live in f32 on the
parameters' device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch._tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "AdamWState", "init_state", "abstract_state",
           "lr_at",
           "global_norm", "apply_updates"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor       # () int32
    mu: dict
    nu: dict


def init_state(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def abstract_state(params) -> AdamWState:
    """:func:`init_state`'s tree as "meta" tensors (shapes and dtypes; no
    memory), whatever device ``params`` lie on."""
    return init_state(tree_map(lambda p: torch.empty(
        p.shape, dtype=p.dtype, device="meta"), params))


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to lr_min_ratio (f32)."""
    step = step.float()
    warm = cfg.lr_peak * step / max(1, cfg.warmup_steps)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(1, cfg.decay_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.lr_min_ratio + (1 - cfg.lr_min_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr_peak * cos)


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(l.float() ** 2) for l in leaves))


def apply_updates(cfg: AdamWConfig, params, grads, state: AdamWState):
    """Returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * \
            p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.mu, state.nu)

    def pick(i):
        return tree_map(lambda o: o[i], out)
    return pick(0), AdamWState(step, pick(1), pick(2)), {
        "grad_norm": gnorm, "lr": lr}
