"""Optimizer and learning-rate schedule for ``adam_onecycle``.

Counterpart of ``pdanet_tpu/train/optimization.py:24-98``, which chains
optax transforms (:88-97); the port applies the same chain in one
``torch.optim.Optimizer`` step, in the same order:

1. global-norm clip: when the norm of all gradients is at least
   ``GRAD_NORM_CLIP``, every gradient is scaled by ``max_norm / norm``
   (``optax.clip_by_global_norm``; ``torch.nn.utils.clip_grad_norm_``
   divides by ``norm + 1e-6`` and is not used);
2. Adam with ``b1`` from the momentum schedule, ``b2`` 0.99, eps 1e-8,
   bias-corrected with the current ``b1`` (``optax.scale_by_adam``);
3. decoupled weight decay on every parameter, BatchNorm and LayerNorm
   included (``bn_wd=True``): ``u + wd * p``;
4. the scheduled learning rate: ``p - lr * u``.

Update *t* (t counts the updates before it) uses ``lr_fn(t)`` and
``mom_fn(t)``, which ``train_utils.make_train_step`` writes into the
parameter groups before each step.  A parameter that received no gradient
takes a zero gradient, as in optax, where every leaf has one.
"""

import math

import torch

_LATER = "ROADMAP queue 1 item 8 (the CLIs and their optimizers)"


def _annealing_cos(start, end, pct):
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)


class OneCycle:
    """The OneCycle learning-rate and momentum schedules over the global
    update count (learning_schedules_fastai.py:53-77): cosine from
    ``lr_max / div_factor`` up to ``lr_max`` over the first ``pct_start`` of
    the updates, then down to ``lr_max / div_factor / 1e4``; the momentum
    anneals ``moms[0] -> moms[1] -> moms[0]`` in the mirrored phases."""

    def __init__(self, total_steps, lr_max, moms, div_factor, pct_start):
        self.total_steps = int(total_steps)
        self.a1 = int(total_steps * pct_start)
        self.lr_max = float(lr_max)
        self.low_lr = self.lr_max / div_factor
        self.moms = (float(moms[0]), float(moms[1]))

    def _phases(self, step):
        p1 = min(max(step / max(self.a1, 1), 0.0), 1.0)
        p2 = min(max((step - self.a1) / max(self.total_steps - self.a1, 1), 0.0), 1.0)
        return step < self.a1, p1, p2

    def lr(self, step):
        first, p1, p2 = self._phases(step)
        if first:
            return _annealing_cos(self.low_lr, self.lr_max, p1)
        return _annealing_cos(self.lr_max, self.low_lr / 1e4, p2)

    def mom(self, step):
        first, p1, p2 = self._phases(step)
        if first:
            return _annealing_cos(self.moms[0], self.moms[1], p1)
        return _annealing_cos(self.moms[1], self.moms[0], p2)


class AdamOneCycle(torch.optim.Optimizer):
    """The optax chain of ``adam_onecycle`` as one optimizer step (module
    docstring).  Per parameter group: ``lr`` and ``b1`` (set each step from
    the schedule), ``b2``, ``eps``, ``weight_decay``, ``max_grad_norm`` and
    ``count``, the number of updates taken.  Per parameter: the first and
    second moments ``mu`` and ``nu``."""

    def __init__(self, params, weight_decay, max_grad_norm, b2=0.99, eps=1e-8):
        defaults = dict(lr=0.0, b1=0.9, b2=b2, eps=eps, weight_decay=weight_decay,
                        max_grad_norm=max_grad_norm, count=0)
        super().__init__(params, defaults)

    @property
    def count(self):
        return self.param_groups[0]["count"]

    def _moments(self, p):
        state = self.state[p]
        if not state:
            state["mu"] = torch.zeros_like(p)
            state["nu"] = torch.zeros_like(p)
        return state["mu"], state["nu"]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamOneCycle.step takes no closure")
        params = [p for g in self.param_groups for p in g["params"]]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        i = 0
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            count = group["count"] + 1
            max_norm = group["max_grad_norm"]
            for p in group["params"]:
                g = grads[i]
                i += 1
                g = torch.where(norm < max_norm, g, g / norm.to(g.dtype) * max_norm)
                mu, nu = self._moments(p)
                mu.mul_(b1).add_(g, alpha=1.0 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                mu_hat = mu / (1.0 - b1 ** count)
                nu_hat = nu / (1.0 - b2 ** count)
                u = mu_hat / (torch.sqrt(nu_hat) + eps) + group["weight_decay"] * p
                p.sub_(group["lr"] * u)
            group["count"] = count
        return None


def build_optimizer_and_schedule(model, optim_cfg, total_iters_each_epoch, total_epochs):
    """``(optimizer, schedule)`` for ``OPTIMIZATION`` of the yaml; only
    ``adam_onecycle`` is ported."""
    name = optim_cfg.OPTIMIZER
    if name != "adam_onecycle":
        raise NotImplementedError(f"optimizer {name} is {_LATER}")
    schedule = OneCycle(total_iters_each_epoch * total_epochs, optim_cfg.LR,
                        list(optim_cfg.MOMS), optim_cfg.DIV_FACTOR, optim_cfg.PCT_START)
    optimizer = AdamOneCycle(model.parameters(), weight_decay=optim_cfg.WEIGHT_DECAY,
                             max_grad_norm=optim_cfg.GRAD_NORM_CLIP)
    return optimizer, schedule
