"""Optimisers: the ``optimizer=`` registry behind the level loop.

``adam``
    The JAX package's default loop, step for step: the update comes first,
    bias-corrected with the 1-based step index as a float32 scalar (so
    ``b1**i`` and ``b2**i`` are float32 powers, as in JAX), then one
    value-and-grad at the new params.

``lbfgs``
    Limited-memory BFGS: the two-loop recursion over a ``history`` window
    (every slot visited, the ones past ``hlen`` masked, as the JAX package
    does), the initial scaling ``s.y / y.y``, a descent safeguard, a
    backtracking Armijo line search whose first probe has unit norm when
    there is no history, one quadratic refinement, and a curvature pair
    pushed only when ``s.y > 1e-10``.  A collapsed search leaves the
    iterate in place (``ok=False``) and empties the window.

``gauss_newton``
    Gauss-Newton for a least-squares objective (SSD, whose ``Objective``
    carries its residual): conjugate gradient with a fixed ``cg_iters`` on
    ``(2/N J^T J + H_reg + damping I) d = -g``, then a Levenberg-Marquardt
    trial.  ``J`` comes from the objective's ``linearize``, built once a
    step: the level and affine objectives keep the warp's derivative in its
    coordinates, so ``J v`` is the forward kernel on the tangent times that
    derivative and ``J^T w`` the adjoint kernel of their product, with no
    primal re-run (``engine.batch.linearize_warp_residual``).  Both
    regularizers are quadratic, so their Hessian product is their gradient
    at ``v``.

Parameters and every optimiser's state are float32 under each
``compute_dtype``: the BSI's analytic adjoint returns the parameters' dtype
and the level loss is scored in float32 (``engine.batch.ffd_level_loss``),
so a bf16 or fp16 forward reaches the optimiser only through float32
values.

The protocol is :func:`opt_step`: ``g`` and ``loss`` are the gradient and
loss at the current params, and the step returns them at the new params with
``ok``.  The line search reads one flag from the device an evaluation (its
condition); Adam and Gauss-Newton read none.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.registry import Registry

__all__ = [
    "OPTIMIZERS",
    "AdamOptimizer",
    "GaussNewtonOptimizer",
    "LbfgsOptimizer",
    "Objective",
    "adam",
    "adam_update",
    "available_optimizers",
    "gauss_newton",
    "init_state",
    "lbfgs",
    "make_objective",
    "opt_step",
    "optimizer_token",
    "resolve_optimizer",
]


@dataclasses.dataclass(frozen=True)
class AdamOptimizer:
    """Adam with the JAX package's defaults."""

    name = "adam"
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def __post_init__(self):
        for field in ("b1", "b2"):
            v = float(getattr(self, field))
            if not 0.0 <= v < 1.0:
                raise ValueError(f"adam {field} must be in [0, 1), got {v}")
            object.__setattr__(self, field, v)
        eps = float(self.eps)
        if not eps > 0:
            raise ValueError(f"adam eps must be > 0, got {eps}")
        object.__setattr__(self, "eps", eps)


@dataclasses.dataclass(frozen=True)
class LbfgsOptimizer:
    """L-BFGS with a backtracking Armijo line search (``lr`` is ignored).

    ``history`` curvature pairs; at most ``max_ls`` evaluations, each step
    ``shrink`` times the last, against the Armijo slope fraction ``c1``.
    """

    name = "lbfgs"
    history: int = 10
    max_ls: int = 10
    c1: float = 1e-4
    shrink: float = 0.5

    def __post_init__(self):
        for field in ("history", "max_ls"):
            v = int(getattr(self, field))
            if not 1 <= v <= 64:
                raise ValueError(f"lbfgs {field} must be in [1, 64], got {v}")
            object.__setattr__(self, field, v)
        for field in ("c1", "shrink"):
            v = float(getattr(self, field))
            if not 0.0 < v < 1.0:
                raise ValueError(f"lbfgs {field} must be in (0, 1), got {v}")
            object.__setattr__(self, field, v)


@dataclasses.dataclass(frozen=True)
class GaussNewtonOptimizer:
    """Gauss-Newton with CG inner solves and Levenberg-Marquardt damping.

    An accepted trial (finite, lower loss) divides the damping by
    ``damp_down``, a rejected one multiplies it by ``damp_up`` and leaves
    the iterate in place, within ``[min_damping, max_damping]``.  Needs a
    residual objective (``similarity="ssd"``); ``lr`` is ignored.
    """

    name = "gauss_newton"
    cg_iters: int = 10
    damping: float = 1e-3
    damp_up: float = 10.0
    damp_down: float = 3.0
    min_damping: float = 1e-8
    max_damping: float = 1e8

    def __post_init__(self):
        k = int(self.cg_iters)
        if not 1 <= k <= 256:
            raise ValueError(f"gauss_newton cg_iters must be in [1, 256], got {k}")
        object.__setattr__(self, "cg_iters", k)
        for field in ("damping", "damp_up", "damp_down", "min_damping", "max_damping"):
            v = float(getattr(self, field))
            if not v > 0:
                raise ValueError(f"gauss_newton {field} must be > 0, got {v}")
            object.__setattr__(self, field, v)
        if self.damp_up <= 1.0 or self.damp_down <= 1.0:
            raise ValueError(
                "gauss_newton damp_up/damp_down must be > 1 (they multiply/divide "
                f"the damping on reject/accept), got {self.damp_up}/{self.damp_down}")


_SPEC_TYPES = (AdamOptimizer, LbfgsOptimizer, GaussNewtonOptimizer)

OPTIMIZERS = Registry("optimizer", passthrough=lambda o: isinstance(o, _SPEC_TYPES))


def adam(b1=0.9, b2=0.999, eps=1e-8) -> AdamOptimizer:
    """An Adam spec (the default)."""
    return AdamOptimizer(b1=b1, b2=b2, eps=eps)


def lbfgs(history=10, max_ls=10, c1=1e-4, shrink=0.5) -> LbfgsOptimizer:
    """An L-BFGS spec."""
    return LbfgsOptimizer(history=history, max_ls=max_ls, c1=c1, shrink=shrink)


def gauss_newton(cg_iters=10, damping=1e-3, damp_up=10.0,
                 damp_down=3.0) -> GaussNewtonOptimizer:
    """A Gauss-Newton spec."""
    return GaussNewtonOptimizer(cg_iters=cg_iters, damping=damping, damp_up=damp_up,
                                damp_down=damp_down)


OPTIMIZERS.register("adam", AdamOptimizer())
OPTIMIZERS.register("lbfgs", LbfgsOptimizer())
OPTIMIZERS.register("gauss_newton", GaussNewtonOptimizer())


def available_optimizers():
    """Sorted names of the registered optimisers."""
    return OPTIMIZERS.names()


def resolve_optimizer(optimizer):
    """Resolve a name-or-spec to a frozen optimiser spec instance."""
    _, spec = OPTIMIZERS.resolve(optimizer)
    return spec


def optimizer_token(optimizer) -> str:
    """A short string naming the optimiser for cache keys and logs; the
    default Adam is plain ``"adam"``."""
    spec = resolve_optimizer(optimizer)
    if isinstance(spec, AdamOptimizer):
        if spec == AdamOptimizer():
            return "adam"
        return f"adam(b1={spec.b1:g},b2={spec.b2:g},eps={spec.eps:g})"
    if isinstance(spec, LbfgsOptimizer):
        return f"lbfgs(history={spec.history},max_ls={spec.max_ls})"
    return f"gauss_newton(cg={spec.cg_iters},damping={spec.damping:g})"


class Objective(NamedTuple):
    """The function a step minimises.

    ``loss(p)`` and ``vg(p) -> (loss, grad)`` always; ``residual(p)``, the
    flat residual with ``similarity = mean(residual**2)``, ``reg(p)``, the
    (quadratic) regularisation term, and ``linearize(p) -> (r, jvp, vjp)``,
    the residual at ``p`` with its products ``J v`` and ``J^T w``, only for
    least-squares objectives, where ``loss == mean(residual**2) + reg``:
    what Gauss-Newton linearises.
    """

    loss: Callable
    vg: Callable
    residual: Any = None
    reg: Any = None
    linearize: Any = None


def _forward_mode_linearization(residual_fn):
    """``linearize`` for a bare residual: ``J v`` by forward mode through it,
    which re-runs its primal each product, and ``J^T w`` by the backward of
    one graph kept for the step."""

    def linearize(p):
        p = p.detach()
        with torch.enable_grad():
            pg = p.clone().requires_grad_(True)
            r0 = residual_fn(pg)

        def jvp(v):
            return torch.func.jvp(residual_fn, (p,), (v,))[1]

        def vjp(w):
            return torch.autograd.grad(r0, pg, w, retain_graph=True)[0]

        return r0.detach(), jvp, vjp

    return linearize


def make_objective(loss_fn, *, residual_fn=None, reg_fn=None,
                   linearize_fn=None) -> Objective:
    """Wrap a scalar loss (and the optional residual form) as an
    :class:`Objective`; with ``loss_fn=None`` the loss is
    ``mean(residual**2) + reg``.  Without ``linearize_fn`` a residual is
    linearised by forward mode through it."""
    if residual_fn is not None and linearize_fn is None:
        linearize_fn = _forward_mode_linearization(residual_fn)
    if loss_fn is None:
        if residual_fn is None:
            raise ValueError("make_objective needs loss_fn or residual_fn")

        def loss_fn(p):
            sim = torch.mean(torch.square(residual_fn(p)))
            return sim + (reg_fn(p) if reg_fn is not None else 0.0)

    def vg(p):
        p = p.detach().requires_grad_(True)
        loss = loss_fn(p)
        (g,) = torch.autograd.grad(loss, p)
        return loss.detach(), g

    def loss(p):
        with torch.no_grad():
            return loss_fn(p)

    return Objective(loss=loss, vg=vg, residual=residual_fn, reg=reg_fn,
                     linearize=linearize_fn)


def adam_update(p, m, v, g, i, *, lr, b1=0.9, b2=0.999, eps=1e-8):
    """One Adam update, bias-corrected with step index ``i`` (1-based)."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mh = m / (1 - b1**i)
    vh = v / (1 - b2**i)
    return p - lr * mh / (torch.sqrt(vh) + eps), m, v


def _dot(a, b):
    """Flat float32 dot product of two same-shaped tensors."""
    return torch.dot(a.reshape(-1).float(), b.reshape(-1).float())


def init_state(optimizer, params) -> dict:
    """The optimiser state for ``params``, float32 tensors on their device:
    Adam's moments ``m``, ``v``; L-BFGS's window ``s``, ``y``, ``rho`` and
    its length ``hlen``; Gauss-Newton's ``damping``."""
    spec = resolve_optimizer(optimizer)
    dev = params.device
    zeros = torch.zeros(params.shape, dtype=torch.float32, device=dev)
    if isinstance(spec, AdamOptimizer):
        return {"m": zeros, "v": zeros}
    if isinstance(spec, LbfgsOptimizer):
        h = spec.history
        return {"s": torch.zeros((h,) + tuple(params.shape), dtype=torch.float32,
                                 device=dev),
                "y": torch.zeros((h,) + tuple(params.shape), dtype=torch.float32,
                                 device=dev),
                "rho": torch.zeros((h,), dtype=torch.float32, device=dev),
                "hlen": torch.zeros((), dtype=torch.int32, device=dev)}
    return {"damping": torch.full((), spec.damping, dtype=torch.float32, device=dev)}


def opt_step(optimizer, obj, k, p, opt, g, loss, *, lr):
    """One step from ``(p, g, loss)`` at the current params (``k`` 0-based).

    Returns ``(p1, opt1, g1, loss1, ok)`` with ``g1``/``loss1`` at ``p1``;
    ``ok`` (a bool, or a device bool for Gauss-Newton) is false for a
    rejected step, whose ``p1``, ``g1`` and ``loss1`` equal its inputs.
    """
    spec = resolve_optimizer(optimizer)
    if isinstance(spec, AdamOptimizer):
        return _adam_step(spec, obj, k, p, opt, g, lr=lr)
    if isinstance(spec, LbfgsOptimizer):
        return _lbfgs_step(spec, obj, p, opt, g, loss)
    return _gauss_newton_step(spec, obj, p, opt, g, loss)


def _adam_step(spec, obj, k, p, opt, g, *, lr):
    # a fill on the device: a host-to-device copy would synchronise every step
    i = torch.full((), k + 1, dtype=torch.float32, device=p.device)
    p, m, v = adam_update(p, opt["m"], opt["v"], g, i, lr=lr, b1=spec.b1, b2=spec.b2,
                          eps=spec.eps)
    loss, g = obj.vg(p)
    return p, {"m": m, "v": v}, g, loss, True


def _lbfgs_direction(s_hist, y_hist, rho, hlen, gd):
    """The two-loop recursion, newest pair at index 0; slots past ``hlen``
    are masked to 0, as in the JAX package."""
    zero = gd.new_zeros(())
    q, alphas = gd, []
    for i in range(s_hist.shape[0]):
        a = torch.where(i < hlen, rho[i] * _dot(s_hist[i], q), zero)
        q = q - a * y_hist[i]
        alphas.append(a)
    gamma = torch.where(hlen > 0, _dot(s_hist[0], y_hist[0])
                        / torch.clamp(_dot(y_hist[0], y_hist[0]), min=1e-30),
                        zero + 1.0)
    r = gamma * q
    for i in range(s_hist.shape[0] - 1, -1, -1):
        b = torch.where(i < hlen, rho[i] * _dot(y_hist[i], r), zero)
        r = r + (alphas[i] - b) * s_hist[i]
    return -r


def _lbfgs_step(spec, obj, p, opt, g, loss):
    h = spec.history
    gd = g.float()
    loss = loss.float()
    s_hist, y_hist, rho, hlen = opt["s"], opt["y"], opt["rho"], opt["hlen"]
    d = _lbfgs_direction(s_hist, y_hist, rho, hlen, gd)

    # descent safeguard: a degenerate window may propose an ascent (or
    # non-finite) direction; restart from steepest descent
    dg = _dot(d, gd)
    bad = torch.logical_or(dg >= 0, ~torch.isfinite(dg))
    d = torch.where(bad, -gd, d)
    dg = torch.where(bad, -_dot(gd, gd), dg)

    # backtracking Armijo search; with no curvature history the first probe
    # has unit norm (a raw registration gradient may be orders of magnitude
    # off the displacements the problem needs)
    gnorm = torch.sqrt(_dot(d, d))
    t = torch.where(hlen > 0, gnorm.new_ones(()),
                    1.0 / torch.clamp(gnorm, min=1e-12))
    t_acc, f_acc, ok = None, loss, False
    for _ in range(spec.max_ls):
        f_t = obj.loss(p + t * d).float()
        accept = torch.logical_and(torch.isfinite(f_t), f_t <= loss + spec.c1 * t * dg)
        if bool(accept):  # the search's one read of the device an evaluation
            t_acc, f_acc, ok = t, f_t, True
            break
        t = t * spec.shrink
    if not ok:
        # a collapsed search: the iterate stays, and the window empties (the
        # same state would propose the same step again)
        opt1 = dict(opt, hlen=torch.zeros_like(hlen))
        return p, opt1, g, loss, False

    # one quadratic-interpolation refinement through (f(p), dg, f(p + t d)),
    # its minimiser clipped to [0, 8 t], kept only if it is lower
    denom = 2.0 * (f_acc - loss - dg * t_acc)
    t_q = torch.where(denom > 0, -dg * t_acc * t_acc / torch.clamp(denom, min=1e-30),
                      t_acc)
    t_q = torch.minimum(torch.clamp(t_q, min=0.0), 8.0 * t_acc)
    f_q = obj.loss(p + t_q * d).float()
    refine = torch.logical_and(torch.isfinite(f_q), f_q < f_acc)
    t_acc = torch.where(refine, t_q, t_acc)

    p1 = p + t_acc * d
    loss1, g1 = obj.vg(p1)

    # keep the pair only if s.y > 0, so the inverse-Hessian stays positive
    # definite
    s_new = (p1 - p).float()
    y_new = (g1 - g).float()
    sy = _dot(s_new, y_new)
    push = sy > 1e-10
    opt1 = {
        "s": torch.where(push, torch.cat([s_new[None], s_hist[:-1]]), s_hist),
        "y": torch.where(push, torch.cat([y_new[None], y_hist[:-1]]), y_hist),
        "rho": torch.where(push, torch.cat([(1.0 / torch.clamp(sy, min=1e-30))[None],
                                            rho[:-1]]), rho),
        "hlen": torch.where(push, torch.clamp(hlen + 1, max=h), hlen),
    }
    return p1, opt1, g1, loss1, True


def _gauss_newton_step(spec, obj, p, opt, g, loss):
    if obj.linearize is None:
        raise ValueError(
            "optimizer='gauss_newton' needs a residual objective (similarity='ssd'); "
            "this objective has none")
    lam = opt["damping"]
    p = p.detach()

    # linearise the residual once a step: J v and J^T w reuse what the
    # primal computed (the adjoint kernel for J^T, the forward kernel on the
    # tangent for J)
    r0, jvp, vjp = obj.linearize(p)
    scale = (torch.tensor(2.0) / r0.numel()).item()  # 2/N in float32, as JAX rounds it

    def reg_hvp(v):
        # the regularizers are quadratic: H v = grad(reg)(v)
        if obj.reg is None:
            return torch.zeros_like(v)
        with torch.enable_grad():
            vg = v.detach().requires_grad_(True)
            (out,) = torch.autograd.grad(obj.reg(vg), vg)
        return out

    def hess_v(v):
        return scale * vjp(jvp(v)) + reg_hvp(v) + lam * v

    # CG on (H + lam I) d = -g with a fixed number of iterations
    b = -g.float()
    x, res, direc, rs = torch.zeros_like(b), b, b, _dot(b, b)
    for _ in range(spec.cg_iters):
        hd = hess_v(direc)
        alpha = rs / torch.clamp(_dot(direc, hd), min=1e-30)
        x = x + alpha * direc
        res = res - alpha * hd
        rs_new = _dot(res, res)
        beta = rs_new / torch.clamp(rs, min=1e-30)
        direc, rs = res + beta * direc, rs_new
    d = x
    del r0, jvp, vjp

    # the LM trial: only a finite, strictly lower loss is taken; a refused
    # step leaves the iterate in place and raises the damping
    loss_try = obj.loss(p + d).float()
    ok = torch.isfinite(loss_try) & (loss_try < loss.float()) & torch.isfinite(d).all()
    p1 = p + torch.where(ok, 1.0, 0.0) * d
    loss1, g1 = obj.vg(p1)
    lam1 = torch.where(ok, torch.clamp(lam / spec.damp_down, min=spec.min_damping),
                       torch.clamp(lam * spec.damp_up, max=spec.max_damping))
    return p1, {"damping": lam1}, g1, loss1, ok
