"""Optimizers with reference parity, and learning-rate schedules.

Counterpart of ``recalgorithm_tpu/train/optimizers.py``: ``build`` for
adam, adagrad, rmsprop, sgd, ftrl and lazyadam, ``make_schedule``, and the
Wide&Deep dual optimizer ``dual_wide_deep``.

``torch.optim.Adam`` computes optax's Adam update:
``lr * m_hat / (sqrt(v_hat) + eps)`` with bias-corrected moments, and
``torch.optim.SGD`` without momentum optax's ``sgd``.  Adagrad and RMSProp
are not torch's: optax puts eps inside the square root (torch outside), and
its RMSProp decays by 0.9 (torch 0.99), so :class:`Adagrad` and
:class:`RMSProp` below compute optax's formulas.  :class:`Ftrl` is the JAX
package's own FTRL-proximal (TF1 ``FtrlOptimizer`` semantics), and
:class:`LazyAdam` its ``lazy_adam`` (TF contrib's LazyAdamOptimizer).  A schedule is a function
of the 0-based count of updates already applied, as
``optax.scale_by_schedule`` evaluates it; :class:`Optimizer` sets the rate
before each step.

The four optimizers of this module update every parameter of a group with
one chain of multi-tensor ``torch._foreach_*`` ops (a launch chain for all
parameters, not one a parameter), and ``torch.optim.Adam`` and ``SGD`` take
their own multi-tensor path on CUDA tensors by default.  So the JAX
package's ``maybe_fuse`` (``optax.flatten``, one flat buffer) has nothing
left to do here: ``TrainerConfig.fuse_optimizer`` is accepted and changes
nothing.  Every update is coordinate-wise, so it is bitwise the same
whatever the grouping.

A CUDA graph can hold the update of an optimizer class whose ``graph_safe``
is True: :class:`Adam`, :class:`SGD` and :class:`LazyAdam`.  On CUDA
parameters ``build`` makes them with the rate as a 0-d device tensor (Adam
fused and ``capturable``, SGD fused, LazyAdam with its count on the device),
which :class:`Optimizer` writes in place before each update, so a replayed
update reads the schedule's rate of its count.  Adagrad, RMSProp and FTRL
read the rate on the host: their steps stay eager.  :class:`Adagrad`
(``row_grads``) also takes a table's row gradient and updates the touched
rows alone.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Sequence

import torch

from recalgorithm_tpu_torch.ops.cuda.row_adagrad import row_adagrad
from recalgorithm_tpu_torch.utils.summary import span

Schedule = Callable[[int], float]


def make_schedule(learning_rate: float, schedule: str = "constant",
                  warmup_steps: int = 0, decay_steps: int = 0,
                  end_lr_factor: float = 0.01) -> Schedule:
    """LR schedule factory (beyond reference — the reference trains at a
    fixed LR only).

      constant     flat LR (optionally after linear warmup)
      cosine       cosine decay to end_lr_factor * lr over decay_steps
      exponential  x0.1 every decay_steps (staircase off)

    Warmup ramps linearly from 0 over ``warmup_steps`` and composes with
    any of the above (the body then starts at step ``warmup_steps``).
    """
    schedule = schedule.lower()
    if schedule == "constant":
        body = lambda step: learning_rate
    elif schedule == "cosine":
        if decay_steps <= 0:
            raise ValueError("cosine schedule requires decay_steps > 0")

        def body(step):
            frac = min(step, decay_steps) / decay_steps
            decay = 0.5 * (1.0 + math.cos(math.pi * frac))
            return learning_rate * ((1.0 - end_lr_factor) * decay + end_lr_factor)
    elif schedule == "exponential":
        if decay_steps <= 0:
            raise ValueError("exponential schedule requires decay_steps > 0")
        body = lambda step: learning_rate * 0.1 ** (step / decay_steps)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    if warmup_steps <= 0:
        return body
    return lambda step: (learning_rate * step / warmup_steps if step < warmup_steps
                         else body(step - warmup_steps))


def _with_grads(group: dict, state, init) -> tuple[list, list, list]:
    """The parameters of ``group`` that have a gradient, their gradients, and
    their state dicts (``init(p)`` fills an empty one)."""
    params = [p for p in group["params"] if p.grad is not None]
    states = []
    for p in params:
        if not state[p]:
            state[p].update(init(p))
        states.append(state[p])
    return params, [p.grad for p in params], states


class Adam(torch.optim.Adam):
    """``torch.optim.Adam``, whose update is optax's; graph-safe when built on
    CUDA as ``build`` builds it (fused, ``capturable``, a tensor rate)."""

    graph_safe = True

    def __init__(self, params, lr, **kwargs):
        super().__init__(params, lr=lr, **kwargs)
        # a graph-safe instance also steps eagerly (a graph's warm-up,
        # accumulation, a mesh): torch's warning about that does not apply
        self._warned_capturable_if_run_uncaptured = True


class SGD(torch.optim.SGD):
    """``torch.optim.SGD`` without momentum, optax's ``sgd``; graph-safe when
    built on CUDA as ``build`` builds it (fused, a tensor rate)."""

    graph_safe = True


# A multi-tensor chain makes temporaries of every tensor it takes at once:
# an update runs its chain over groups of at most this many elements (a
# larger tensor alone), so beside tables of many GB its temporaries stay at
# the size of one table.  Parameters this small in all run as one group.
FOREACH_GROUP_ELEMENTS = 1 << 26


def _groups(params: list, *lists: list):
    """``params`` and the lists beside them cut into runs whose elements
    add up to at most FOREACH_GROUP_ELEMENTS (a larger tensor alone)."""
    start, total = 0, 0
    for i, p in enumerate(params):
        if i > start and total + p.numel() > FOREACH_GROUP_ELEMENTS:
            yield (params[start:i], *(x[start:i] for x in lists))
            start, total = i, 0
        total += p.numel()
    if params:
        yield (params[start:], *(x[start:] for x in lists))


class Adagrad(torch.optim.Optimizer):
    """``optax.adagrad(lr, initial_accumulator_value, eps)``: acc += g^2, then
    p -= lr * g * rsqrt(acc + eps) where acc > 0 (else no step).  The
    accumulator starts at the reference's 1e-8 (wide_and_deep.py:264-265),
    as the JAX package's ``build("adagrad")`` sets it.  A dense gradient's
    update runs over groups of at most FOREACH_GROUP_ELEMENTS elements.

    ``row_grads``: a parameter whose gradient is a row gradient (a sparse
    COO tensor of ids beside gradient rows, ``embed/tables.
    row_sparse_grads``) is updated on those rows alone, by
    ``ops/cuda/row_adagrad.row_adagrad`` (span ``train.row_update``): an
    untouched row's gradient is 0 and it would not move, so the result is
    the dense update's.  Its state stays the dense ``sum_of_squares``."""

    row_grads = True

    def __init__(self, params, lr: float, initial_accumulator_value: float = 1e-8,
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, initial_accumulator_value=initial_accumulator_value,
                                      eps=eps))

    @torch.no_grad()
    def step(self) -> None:
        for group in self.param_groups:
            params, grads, states = _with_grads(group, self.state, lambda p: {
                "sum_of_squares": torch.full_like(p, group["initial_accumulator_value"])})
            dense = [i for i, g in enumerate(grads) if not g.is_sparse]
            if len(dense) < len(params):
                with span("train.row_update"):
                    for p, g, st in zip(params, grads, states):
                        if g.is_sparse:
                            row_adagrad(p, st["sum_of_squares"], g._indices()[0],
                                        g._values(), group["lr"], group["eps"])
                params, grads, states = ([x[i] for i in dense] for x in (params, grads, states))
            if not params:  # no parameter of the group has a dense gradient
                continue
            accs = [st["sum_of_squares"] for st in states]
            for ps, gs, acs in _groups(params, grads, accs):
                torch._foreach_add_(acs, torch._foreach_mul(gs, gs))
                # where(acc > 0, r, 0) as r * sign(acc): acc >= 0 and r is finite
                scales = torch._foreach_rsqrt(torch._foreach_add(acs, group["eps"]))
                torch._foreach_mul_(scales, torch._foreach_sign(acs))
                torch._foreach_add_(ps, torch._foreach_mul(scales, gs), alpha=-group["lr"])
                del scales


class RMSProp(torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay, eps)`` (not centered, no momentum, nu
    starting at 0): nu = (1 - decay) g^2 + decay nu, then
    p -= lr * g * rsqrt(nu + eps)."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self) -> None:
        for group in self.param_groups:
            decay, eps, lr = group["decay"], group["eps"], group["lr"]
            params, grads, states = _with_grads(group, self.state,
                                                lambda p: {"nu": torch.zeros_like(p)})
            if not params:  # no parameter of the group has a gradient
                continue
            nus = [st["nu"] for st in states]
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1 - decay)
            torch._foreach_mul_(nus, decay)
            torch._foreach_add_(nus, sq)
            r = torch._foreach_rsqrt(torch._foreach_add(nus, eps))
            torch._foreach_add_(params, torch._foreach_mul(r, grads), alpha=-lr)


class Ftrl(torch.optim.Optimizer):
    """FTRL-proximal with TF1 ``FtrlOptimizer`` defaults (McMahan et al.), as
    the JAX package's ``ftrl``: per-coordinate accumulators n (from
    ``initial_accumulator_value``) and z (from 0), ``learning_rate_power``
    p = -0.5, optional l1/l2.  Each step

        n' = n + g^2;  z' = z + g - (n'^-p - n^-p) / lr * w;
        w  = -(z' - sign(z') l1) / (n'^-p / lr + 2 l2)  where |z'| > l1, else 0

    *replaces* the parameter, as TF's does.  A constant learning rate only
    (the reference's wide part)."""

    def __init__(self, params, lr: float, learning_rate_power: float = -0.5,
                 initial_accumulator_value: float = 0.1,
                 l1_regularization_strength: float = 0.0,
                 l2_regularization_strength: float = 0.0):
        super().__init__(params, dict(lr=lr, power=learning_rate_power,
                                      initial_accumulator_value=initial_accumulator_value,
                                      l1=l1_regularization_strength,
                                      l2=l2_regularization_strength))

    @torch.no_grad()
    def step(self) -> None:
        for group in self.param_groups:
            alpha, p, l1, l2 = group["lr"], group["power"], group["l1"], group["l2"]
            params, grads, states = _with_grads(group, self.state, lambda w: {
                "z": torch.zeros_like(w),
                "n": torch.full_like(w, group["initial_accumulator_value"])})
            if not params:  # no parameter of the group has a gradient
                continue
            zs, ns = [st["z"] for st in states], [st["n"] for st in states]
            old = torch._foreach_pow(ns, -p)
            torch._foreach_add_(ns, torch._foreach_mul(grads, grads))  # n'
            new = torch._foreach_pow(ns, -p)
            sigma = torch._foreach_sub(new, old)
            torch._foreach_div_(sigma, alpha)
            torch._foreach_mul_(sigma, params)
            torch._foreach_add_(zs, grads)
            torch._foreach_sub_(zs, sigma)
            denom = torch._foreach_div(new, alpha)
            torch._foreach_add_(denom, 2.0 * l2)
            shrunk = torch._foreach_mul(torch._foreach_sign(zs), l1)
            shrunk = torch._foreach_sub(zs, shrunk)
            torch._foreach_neg_(shrunk)
            torch._foreach_div_(shrunk, denom)
            for w, z, s in zip(params, zs, shrunk):  # the select has no multi-tensor op
                w.copy_(torch.where(z.abs() > l1, s, torch.zeros_like(z)))


class LazyAdam(torch.optim.Optimizer):
    """The JAX package's ``lazy_adam`` (TF contrib LazyAdamOptimizer, DIEN's
    optimizer, reference dien.py:328-329): the moments and the parameter
    move only where the gradient is nonzero,

        m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2,
        p -= lr * (m / (1 - b1^n)) / (sqrt(v / (1 - b2^n)) + eps)   where g != 0,

    with the bias correction from the scalar GLOBAL count n of updates
    (``count`` in each param group, so it checkpoints with the groups), not
    a per-coordinate one.  A parameter with no gradient in a step (``None``)
    counts as an all-zero gradient: it does not move, and n still advances.
    The correction factors are f32, as the JAX update computes them.

    ``count`` is a 0-d int64 tensor on the parameters' device, which the
    update advances itself, and the corrections stay there as 0-d tensors:
    nothing is read back to the host, so with a tensor rate (``build`` makes
    one on CUDA parameters) the update can be captured.  A checkpoint holds
    the count as an int (:meth:`Optimizer.state_dict`)."""

    graph_safe = True

    def __init__(self, params, lr: float | torch.Tensor,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))
        for group in self.param_groups:
            group["count"] = torch.zeros((), dtype=torch.int64,
                                         device=group["params"][0].device)

    @torch.no_grad()
    def step(self) -> None:
        for group in self.param_groups:
            b1, b2 = group["betas"]
            n = group["count"].add_(1).to(torch.float32)
            c1 = 1 - torch.full_like(n, b1) ** n
            c2 = 1 - torch.full_like(n, b2) ** n
            params, grads, states = _with_grads(group, self.state, lambda p: {
                "mu": torch.zeros_like(p), "nu": torch.zeros_like(p)})
            if not params:  # no parameter of the group has a gradient
                continue
            mus, nus = [st["mu"] for st in states], [st["nu"] for st in states]
            mu_new = torch._foreach_mul(mus, b1)
            torch._foreach_add_(mu_new, torch._foreach_mul(grads, 1 - b1))
            nu_new = torch._foreach_mul(nus, b2)
            sq = torch._foreach_mul(grads, 1 - b2)
            torch._foreach_mul_(sq, grads)
            torch._foreach_add_(nu_new, sq)
            # the moments and the parameter move only where g != 0 (the
            # select has no multi-tensor op)
            hits = [g != 0 for g in grads]
            for hit, mu, nu, mn, nn in zip(hits, mus, nus, mu_new, nu_new):
                mu.copy_(torch.where(hit, mn, mu))
                nu.copy_(torch.where(hit, nn, nu))
            den = torch._foreach_sqrt(torch._foreach_div(nus, c2))
            torch._foreach_add_(den, group["eps"])
            steps = torch._foreach_div(mus, c1)
            torch._foreach_mul_(steps, -group["lr"])
            torch._foreach_div_(steps, den)
            for p, hit, s in zip(params, hits, steps):
                p.add_(torch.where(hit, s, torch.zeros_like(s)))


class Optimizer:
    """A torch optimizer stepped as optax steps its transformation: the
    scheduled rate of update ``count`` is set before the update.

    A step is two halves: :meth:`prepare` on the host (the rate written, the
    count advanced) and :meth:`apply` on the device (the update, what a CUDA
    graph holds).  ``capturable``: the update may be captured, i.e. the
    optimizer's class is ``graph_safe`` and its rate a tensor.
    ``row_grads``: the class applies row gradients.  ``version``
    counts the loads of state, which replace the state tensors a captured
    update reads."""

    def __init__(self, opt: torch.optim.Optimizer, schedule: Schedule):
        self.opt = opt
        self.schedule = schedule
        self.count = 0
        self.version = 0
        lr = opt.param_groups[0]["lr"]
        self._lr = lr if torch.is_tensor(lr) else None
        self._lr_written = float(lr) if self._lr is not None else None
        self.capturable = self._lr is not None and getattr(type(opt), "graph_safe", False)
        self.row_grads = getattr(type(opt), "row_grads", False)
        # what the instance was built with; a loaded state keeps them
        self._built = [{k: g[k] for k in ("lr", "capturable", "fused") if k in g}
                       | ({"count": g["count"]} if torch.is_tensor(g.get("count")) else {})
                       for g in opt.param_groups]

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def prepare(self) -> None:
        """The rate of update ``count`` into the groups (into the tensor
        rate in place, where it changed), then the count advanced."""
        lr = self.schedule(self.count)
        if self._lr is None:
            for group in self.opt.param_groups:
                group["lr"] = lr
        elif lr != self._lr_written:
            self._lr.fill_(lr)
            self._lr_written = lr
        self.count += 1

    def apply(self) -> None:
        """The update with the rate :meth:`prepare` wrote."""
        self.opt.step()

    def step(self) -> None:
        self.prepare()
        self.apply()

    def state_dict(self) -> dict:
        sd = self.opt.state_dict()  # its groups are copies
        for group in sd["param_groups"]:
            if torch.is_tensor(group["lr"]):
                group["lr"] = float(group["lr"])
            if torch.is_tensor(group.get("count")):  # LazyAdam's, stored as an int
                group["count"] = int(group["count"])
        return {"opt": sd, "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["opt"])
        for group, built in zip(self.opt.param_groups, self._built):
            count = group.get("count")
            group.update(built)
            if torch.is_tensor(group.get("count")):  # into the tensor a captured update reads
                group["count"].fill_(int(count))
        if self.capturable:  # the counts where a captured update reads them
            for st in self.opt.state.values():
                if "step" in st:
                    st["step"] = st["step"].to(self._lr.device, torch.float32)
        self.count = int(state["count"])
        self.version += 1


def build(name: str, learning_rate: float | Schedule, **options
          ) -> Callable[[Iterable[torch.nn.Parameter]], Optimizer]:
    """Optimizer factory with the reference's names and defaults; returns a
    function of the parameters.  ``learning_rate`` is a float or a schedule.
    ``options`` go to the adagrad, rmsprop and ftrl classes (their keyword
    arguments, such as Adagrad's ``initial_accumulator_value`` and ``eps``;
    a config's ``optimizer_options()``).  Adam, SGD and LazyAdam on CUDA
    parameters are built graph-safe (module docstring)."""
    schedule = learning_rate if callable(learning_rate) else (lambda step: learning_rate)
    name = name.lower()
    if options and name not in ("adagrad", "rmsprop", "ftrl"):
        raise ValueError(f"{name} takes no options, got {sorted(options)}")
    if name == "adam":
        make = lambda params, lr: Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                       **_graph_options(params))
    elif name == "adagrad":
        make = Adagrad
    elif name == "rmsprop":
        make = RMSProp
    elif name == "sgd":
        make = lambda params, lr: SGD(params, lr=lr, fused=_graph_options(params).get("fused"))
    elif name == "ftrl":
        if callable(learning_rate):
            raise ValueError("ftrl takes a constant learning rate")
        make = Ftrl
    elif name == "lazyadam":
        make = LazyAdam
    else:
        raise ValueError(f"unknown optimizer {name!r}")

    def built(params) -> Optimizer:
        params = list(params)
        lr = schedule(0)
        if name in ("adam", "sgd", "lazyadam") and _graph_options(params):
            lr = torch.tensor(float(lr), dtype=torch.float32, device=params[0].device)
        return Optimizer(make(params, lr, **options), schedule)
    return built


def _graph_options(params: list) -> dict:
    """The options that make torch's Adam (both) and SGD (``fused``)
    graph-safe on CUDA parameters; none elsewhere (where ``build`` also
    keeps every rate a float)."""
    if not params or params[0].device.type != "cuda":
        return {}
    return {"capturable": True, "fused": True}


class DualOptimizer:
    """Two :class:`Optimizer` s stepped together, each on its own parameters
    (``optax.multi_transform`` of two labels)."""

    def __init__(self, **parts: Optimizer):
        self.parts = parts

    @property
    def capturable(self) -> bool:
        """Whether every part's update may be captured (its FTRL part's
        cannot: a dual optimizer steps eagerly)."""
        return all(opt.capturable for opt in self.parts.values())

    @property
    def row_grads(self) -> bool:
        """Whether every part applies row gradients (its FTRL part does
        not: a dual optimizer's tables take dense gradients)."""
        return all(opt.row_grads for opt in self.parts.values())

    def zero_grad(self) -> None:
        for opt in self.parts.values():
            opt.zero_grad()

    def step(self) -> None:
        for opt in self.parts.values():
            opt.step()

    def state_dict(self) -> dict:
        return {name: opt.state_dict() for name, opt in self.parts.items()}

    def load_state_dict(self, state: dict) -> None:
        for name, opt in self.parts.items():
            opt.load_state_dict(state[name])


def dual_wide_deep(wide_lr: float, deep_optimizer: str, deep_lr: float,
                   wide_predicate: Callable[[str], bool], names: Sequence[str]
                   ) -> Callable[[Iterable[torch.nn.Parameter]], DualOptimizer]:
    """The Wide&Deep dual optimizer (reference wide_and_deep.py:251-276): FTRL
    at ``wide_lr`` on the parameters ``wide_predicate`` selects by name, the
    ``deep_optimizer`` at ``deep_lr`` on the rest.  ``names``: the model's
    parameter names in ``parameters()`` order, the order the factory
    receives the parameters in."""
    def make(params) -> DualOptimizer:
        params = list(params)
        if len(params) != len(names):
            raise ValueError(f"{len(params)} parameters for {len(names)} names")
        wide = [p for n, p in zip(names, params) if wide_predicate(n)]
        deep = [p for n, p in zip(names, params) if not wide_predicate(n)]
        return DualOptimizer(wide=build("ftrl", wide_lr)(wide),
                             deep=build(deep_optimizer, deep_lr)(deep))
    return make
