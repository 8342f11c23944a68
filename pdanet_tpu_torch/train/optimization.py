"""Optimizers and learning-rate schedules of the yamls' ``OPTIMIZATION``.

Counterpart of ``pdanet_tpu/train/optimization.py``, which chains optax
transforms (:88-127); the port applies the same chain in one
``torch.optim.Optimizer`` step, in the same order:

1. global-norm clip: when the norm of all gradients is at least
   ``GRAD_NORM_CLIP``, every gradient is scaled by ``max_norm / norm``
   (``optax.clip_by_global_norm``; ``torch.nn.utils.clip_grad_norm_``
   divides by ``norm + 1e-6`` and is not used);
2. the trace: Adam, bias-corrected with the current ``b1``
   (``optax.scale_by_adam``), or SGD's momentum trace ``g + m * trace``
   (``optax.trace``);
3. decoupled weight decay on every parameter, BatchNorm and LayerNorm
   included (``bn_wd=True``): ``u + wd * p``;
4. the scheduled learning rate: ``p - lr * u``.

``adam_onecycle`` takes Adam's ``b1`` from the OneCycle momentum schedule,
``b2`` 0.99 and eps 1e-8; ``adam`` optax's defaults (``b1`` 0.9, ``b2``
0.999, eps 1e-8); both ``adam`` and ``sgd`` take the learning rate of
``DecaySteps``.  Update *t* (t counts the updates before it) uses
``schedule.lr(t)`` (and Adam ``schedule.mom(t)``), which
``train_utils.make_train_step`` writes into the parameter groups before
each step.  A parameter that received no gradient takes a zero gradient,
as in optax, where every leaf has one.
"""

import math

import torch


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


class DecaySteps:
    """The reference's LambdaLR over epochs as a schedule over updates
    (``optimization/__init__.py:40-47``; ``decay_steps_schedule`` of the
    JAX package): ``lr`` times ``lr_decay`` for each epoch of
    ``decay_step_list`` reached, floored at ``lr_clip``.  Adam's ``b1``
    stays at optax's 0.9."""

    def __init__(self, total_iters_each_epoch, decay_step_list, lr, lr_decay, lr_clip,
                 b1=0.9):
        self.decay_steps = [x * total_iters_each_epoch for x in decay_step_list]
        self.base_lr, self.lr_decay, self.lr_clip = float(lr), float(lr_decay), float(lr_clip)
        self.b1 = b1

    def lr(self, step):
        cur = 1.0
        for ds in self.decay_steps:
            if step >= ds:
                cur *= self.lr_decay
        return self.base_lr * max(cur, self.lr_clip / self.base_lr)

    def mom(self, step):
        return self.b1


def _clip_by_global_norm(params, max_norm):
    """Each parameter's gradient (zeros where it has none), scaled by
    ``max_norm / norm`` where the global norm is at least ``max_norm``."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    return [torch.where(norm < max_norm, g, g / norm.to(g.dtype) * max_norm) for g in grads]


class AdamOneCycle(torch.optim.Optimizer):
    """The optax Adam chain of ``adam_onecycle`` and ``adam`` as one
    optimizer step (module docstring).  Per parameter group: ``lr`` and
    ``b1`` (set each step from the schedule), ``b2``, ``eps``,
    ``weight_decay``, ``max_grad_norm`` and ``count``, the number of
    updates taken.  Per parameter: the first and second moments ``mu`` and
    ``nu``."""

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
        grads = iter(_clip_by_global_norm(params, self.param_groups[0]["max_grad_norm"]))
        for group in self.param_groups:
            b1, b2, eps = group["b1"], group["b2"], group["eps"]
            count = group["count"] + 1
            for p in group["params"]:
                g = next(grads)
                mu, nu = self._moments(p)
                mu.mul_(b1).add_(g, alpha=1.0 - b1)
                nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                mu_hat = mu / (1.0 - b1 ** count)
                nu_hat = nu / (1.0 - b2 ** count)
                u = mu_hat / (torch.sqrt(nu_hat) + eps) + group["weight_decay"] * p
                p.sub_(group["lr"] * u)
            group["count"] = count
        return None


class SGDMomentum(torch.optim.Optimizer):
    """The optax chain of ``sgd`` as one optimizer step (module docstring):
    the clipped gradient into the trace ``g + momentum * trace`` (no
    dampening, no Nesterov), then the decayed weights and the learning
    rate.  Per parameter group: ``lr`` (set each step from the schedule),
    ``momentum``, ``weight_decay``, ``max_grad_norm`` and ``count``.  Per
    parameter: ``trace``."""

    def __init__(self, params, momentum, weight_decay, max_grad_norm):
        defaults = dict(lr=0.0, momentum=momentum, weight_decay=weight_decay,
                        max_grad_norm=max_grad_norm, count=0)
        super().__init__(params, defaults)

    @property
    def count(self):
        return self.param_groups[0]["count"]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("SGDMomentum.step takes no closure")
        params = [p for g in self.param_groups for p in g["params"]]
        grads = iter(_clip_by_global_norm(params, self.param_groups[0]["max_grad_norm"]))
        for group in self.param_groups:
            for p in group["params"]:
                g = next(grads)
                state = self.state[p]
                if not state:
                    state["trace"] = torch.zeros_like(p)
                trace = state["trace"]
                trace.mul_(group["momentum"]).add_(g)
                p.sub_(group["lr"] * (trace + group["weight_decay"] * p))
            group["count"] += 1
        return None


def build_optimizer_and_schedule(model, optim_cfg, total_iters_each_epoch, total_epochs):
    """``(optimizer, schedule)`` for ``OPTIMIZATION`` of the yaml:
    ``adam_onecycle``, ``adam`` or ``sgd``."""
    name = optim_cfg.OPTIMIZER
    if name == "adam_onecycle":
        schedule = OneCycle(total_iters_each_epoch * total_epochs, optim_cfg.LR,
                            list(optim_cfg.MOMS), optim_cfg.DIV_FACTOR, optim_cfg.PCT_START)
        optimizer = AdamOneCycle(model.parameters(), weight_decay=optim_cfg.WEIGHT_DECAY,
                                 max_grad_norm=optim_cfg.GRAD_NORM_CLIP)
        return optimizer, schedule
    if name not in ("adam", "sgd"):
        raise NotImplementedError(f"optimizer {name}")
    schedule = DecaySteps(total_iters_each_epoch, optim_cfg.DECAY_STEP_LIST, optim_cfg.LR,
                          optim_cfg.LR_DECAY, optim_cfg.LR_CLIP)
    if name == "adam":
        optimizer = AdamOneCycle(model.parameters(), weight_decay=optim_cfg.WEIGHT_DECAY,
                                 max_grad_norm=optim_cfg.GRAD_NORM_CLIP, b2=0.999)
    else:
        optimizer = SGDMomentum(model.parameters(), momentum=optim_cfg.MOMENTUM,
                                weight_decay=optim_cfg.WEIGHT_DECAY,
                                max_grad_norm=optim_cfg.GRAD_NORM_CLIP)
    return optimizer, schedule
