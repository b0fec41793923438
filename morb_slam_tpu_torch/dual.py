"""Forward-mode Jacobians as explicit dual tensors.

`jvp(f, x, tangents, *consts)` returns what `torch.func.jvp` along each
tangent (and so `torch.func.jacfwd`, with unit tangents) returns for the
port's small residual functions (`optim/vi_ba.py:_edge_residual`,
`optim/inertial.py:_edge_residuals` and the `lie` maps they call), bit
for bit and in the same dtypes, without functorch's per-operation
dispatch, which costs ~0.2 ms an operation on the CPU (more where a
constant operand sends an operation through PyTorch's Python reference
implementations).

A `Dual` carries a primal tensor p and its tangents t, (B, *p.shape), one
row a direction. Each operation follows PyTorch's own forward-mode
formula (`derivatives.yaml`: mul `other_t * self_p + self_t * other_p`,
div `(self_t - other_t * result) / other_p`, sqrt `grad / (2 * result)`,
exp, acos, sin, cos, clamp, where, cat and stack) and its dtype
promotion: a constant tensor's missing tangent is a zero of its dtype and
shape, a Python number's a 0-dim float64 zero (so a tangent that is 0-dim
turns float64 where it meets one, as under jacfwd), and the promotion
judges each operand by its rank without the `lead` dims that stand for a
vmap over f. Zero terms are not computed, only their dtypes kept: adding
an exact zero changes no value. A Dual may carry such a zero as its whole
tangent (t None, its dtype in `tdt`): `zero(p, dtype)` makes one, for
inputs whose tangents are known to vanish, and every operation on it
keeps its dtype without computing it. Any torch function outside this
set raises.
"""
from __future__ import annotations

import torch

_F64 = torch.float64


class Dual:
    """A primal tensor p, its tangents t (B, *p.shape), or None for exact
    zeros of dtype tdt, and the number of p's leading dims that stand for
    a vmap (the promotion does not see them)."""
    __slots__ = ("p", "t", "lead", "tdt")

    def __init__(self, p, t, lead: int = 0, tdt=None):
        self.p, self.t, self.lead = p, t, lead
        self.tdt = t.dtype if t is not None else tdt

    def _like(self, p, t):
        """p with tangents t (None where this Dual's are zero)."""
        return Dual(p, None if self.t is None else t, self.lead, self.tdt)

    @property
    def dtype(self):
        return self.p.dtype

    @property
    def device(self):
        return self.p.device

    @property
    def shape(self):
        return self.p.shape

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        h = _HANDLED.get(func)
        if h is None:
            raise NotImplementedError(f"Dual: {func}")
        return h(*args, **(kwargs or {}))

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        t = self.t
        return self._like(self.p[idx],
                          t if t is None else t[(slice(None),) + idx])

    def transpose(self, a, b):
        t = self.t
        return self._like(self.p.transpose(a, b), t if t is None else
                          t.transpose(_tdim(a), _tdim(b)))

    def __neg__(self):
        return self._like(-self.p, self.t if self.t is None else -self.t)

    def __add__(self, o):
        return _add(self, o)

    def __radd__(self, o):
        return _add(o, self)

    def __sub__(self, o):
        return _sub(self, o)

    def __rsub__(self, o):
        # a Python number minus x: rsub.Scalar, tangent -x_t
        return self._like(o - self.p, self.t if self.t is None else -self.t)

    def __mul__(self, o):
        return _mul(self, o)

    def __rmul__(self, o):
        return _mul(o, self)

    def __truediv__(self, o):
        return _div(self, o)

    def __lt__(self, o):
        return self.p < _prim(o)

    def __gt__(self, o):
        return self.p > _prim(o)


def _tdim(d):
    if isinstance(d, int):
        return d if d < 0 else d + 1
    return tuple(_tdim(x) for x in d)


def _prim(x):
    return x.p if isinstance(x, Dual) else x


def _lead(*xs):
    return next(x.lead for x in xs if isinstance(x, Dual))


def _kind(x, lead):
    """(dimensioned, dtype) of x's tangent in a Tensor overload: a Dual's
    own, a tensor constant's zero tangent (its dtype and shape), a Python
    number's zero tangent (a 0-dim float64 tensor, not a wrapped number)."""
    if isinstance(x, Dual):
        return (x.p.dim() > lead, x.tdt)
    if torch.is_tensor(x):
        return (x.dim() > lead, x.dtype)
    return (False, _F64)


def _pkind(x, lead):
    """(dimensioned, dtype) of x's primal; None for a Python number (a
    wrapped number, which takes no part in the promotion)."""
    x = _prim(x)
    return (x.dim() > lead, x.dtype) if torch.is_tensor(x) else None


def _dt(a, b):
    """Result kind of a binary op on operands of kinds a, b."""
    if a is None:
        return b
    if b is None:
        return a
    if a[0] != b[0]:
        return a if a[0] else b
    return (a[0], torch.promote_types(a[1], b[1]))


def _lift(t, nd):
    """A tangent (B, *s) viewed as (B, 1, ..., 1, *s) of nd dims."""
    k = nd - (t.dim() - 1)
    return t if k <= 0 else t.reshape((t.shape[0],) + (1,) * k + t.shape[1:])


def _cast(x, dt):
    return x.to(dt) if torch.is_tensor(x) and x.dtype != dt else x


def _op(f, dt, a, b):
    """f(a, b) in dtype dt: both operands cast first, as a TensorIterator
    with that common dtype does."""
    return f(_cast(a, dt), _cast(b, dt))


class _T:
    """A tangent term: kind and value (None for an exact zero)."""
    __slots__ = ("k", "v")

    def __init__(self, k, v):
        self.k, self.v = k, v


def _tan(x, nd, lead):
    return _T(_kind(x, lead),
              _lift(x.t, nd) if isinstance(x, Dual) and x.t is not None
              else None)


def _tadd(a, b, sub=False):
    k = _dt(a.k, b.k)
    if a.v is None and b.v is None:
        return _T(k, None)
    if b.v is None:
        return _T(k, _cast(a.v, k[1]))
    if a.v is None:
        return _T(k, _cast(-b.v if sub else b.v, k[1]))
    return _T(k, _op(torch.sub if sub else torch.add, k[1], a.v, b.v))


def _tmul(a, y, lead, f=torch.mul):
    """A tangent term times (or over) a primal operand y."""
    k = _dt(a.k, _pkind(y, lead))
    return _T(k, None if a.v is None else _op(f, k[1], a.v, _prim(y)))


def _out(p, t, lead):
    v = t.v
    if v is None:
        return Dual(p, None, lead, t.k[1])
    return Dual(p, v.expand((v.shape[0],) + tuple(p.shape)), lead)


def _add(a, b):
    p, lead = _prim(a) + _prim(b), _lead(a, b)
    nd = p.dim()
    return _out(p, _tadd(_tan(a, nd, lead), _tan(b, nd, lead)), lead)


def _sub(a, b):
    p, lead = _prim(a) - _prim(b), _lead(a, b)
    nd = p.dim()
    return _out(p, _tadd(_tan(a, nd, lead), _tan(b, nd, lead), sub=True),
                lead)


def _mul(a, b):
    """mul.Tensor: other_t * self_p + self_t * other_p."""
    p, lead = _prim(a) * _prim(b), _lead(a, b)
    nd = p.dim()
    return _out(p, _tadd(_tmul(_tan(b, nd, lead), a, lead),
                         _tmul(_tan(a, nd, lead), b, lead)), lead)


def _div(a, b):
    """div.Tensor: (self_t - other_t * result) / other_p."""
    p, lead = _prim(a) / _prim(b), _lead(a, b)
    nd = p.dim()
    s = _tadd(_tan(a, nd, lead), _tmul(_tan(b, nd, lead), p, lead),
              sub=True)
    return _out(p, _tmul(s, b, lead, torch.div), lead)


def _unary(x, p, factor, f=torch.mul):
    """The tangent of an elementwise p = g(x): x_t times (or over) factor."""
    return _out(p, _tmul(_tan(x, p.dim(), x.lead), factor, x.lead, f),
                x.lead)


def _sqrt(x):
    """grad / (2 * result)"""
    r = torch.sqrt(x.p)
    return _unary(x, r, 2 * r, torch.div)


def _exp(x):
    """grad * result"""
    r = torch.exp(x.p)
    return _unary(x, r, r)


def _sin(x):
    return _unary(x, torch.sin(x.p), torch.cos(x.p))


def _cos(x):
    return _unary(x, torch.cos(x.p), -torch.sin(x.p))


def _acos(x):
    """grad * -((-self * self + 1).rsqrt())"""
    return _unary(x, torch.arccos(x.p), -((-x.p * x.p + 1).rsqrt()))


def _abs(x):
    return _unary(x, torch.abs(x.p), x.p.sgn())


def _clamp(x, min=None, max=None):
    """where(self in [min, max], grad, 0-dim zero of grad's dtype)"""
    p = torch.clamp(x.p, min=min, max=max)
    if min is not None and max is not None:
        keep = (x.p >= min).logical_and_(x.p <= max)
    elif min is not None:
        keep = x.p >= min
    else:
        keep = x.p <= max
    if x.t is None:
        return x._like(p, None)
    zero = torch.zeros((), dtype=x.t.dtype, device=x.t.device)
    return Dual(p, torch.where(keep, x.t, zero), x.lead)


def _sum(x, dim=None, keepdim=False):
    p = torch.sum(x.p, dim=dim, keepdim=keepdim)
    if x.t is None:
        return x._like(p, None)
    return Dual(p, torch.sum(x.t, dim=_tdim(dim), keepdim=keepdim), x.lead)


def _cat_like(fn, ts, dim):
    """cat_jvp / stack_jvp: the tangents (zeros for constants) joined,
    promoted across all inputs."""
    p = fn([_prim(x) for x in ts], dim=dim)
    lead = _lead(*ts)
    dt = None
    for x in ts:
        k = _kind(x, lead)[1]
        dt = k if dt is None else torch.promote_types(dt, k)
    B = next((x.t.shape[0] for x in ts
              if isinstance(x, Dual) and x.t is not None), None)
    if B is None:
        return Dual(p, None, lead, dt)
    parts = [_cast(x.t, dt) if isinstance(x, Dual) and x.t is not None else
             torch.zeros((B,) + tuple(x.shape), dtype=dt, device=x.device)
             for x in ts]
    return Dual(p, fn(parts, dim=_tdim(dim)), lead)


def _stack(ts, dim=0):
    return _cat_like(torch.stack, ts, dim)


def _cat(ts, dim=0):
    return _cat_like(torch.cat, ts, dim)


def _where(cond, a, b):
    """where(condition, self_t, other_t), zeros for constants."""
    p, lead = torch.where(cond, _prim(a), _prim(b)), _lead(a, b)
    nd = p.dim()
    ta, tb = _tan(a, nd, lead), _tan(b, nd, lead)
    dt = _dt(ta.k, tb.k)[1]
    if ta.v is None and tb.v is None:
        return Dual(p, None, lead, dt)

    def val(t):
        if t.v is not None:
            return _cast(t.v, dt)
        return torch.zeros((1,) * (nd + 1), dtype=dt, device=p.device)
    return Dual(p, torch.where(cond, val(ta), val(tb)), lead)


def _gather(x, dim, index):
    p = torch.gather(x.p, dim, index)
    if x.t is None:
        return x._like(p, None)
    ti = index.expand((x.t.shape[0],) + tuple(index.shape))
    return Dual(p, torch.gather(x.t, _tdim(dim), ti), x.lead)


def _primal_only(fn):
    def h(x, *a, **k):
        return fn(_prim(x), *a, **k)
    return h


_HANDLED = {
    torch.sqrt: _sqrt, torch.sin: _sin, torch.cos: _cos, torch.exp: _exp,
    torch.arccos: _acos, torch.clamp: _clamp, torch.abs: _abs,
    torch.sum: _sum, torch.stack: _stack, torch.cat: _cat,
    torch.where: _where, torch.gather: _gather,
    torch.zeros_like: _primal_only(torch.zeros_like),
    torch.ones_like: _primal_only(torch.ones_like),
    torch.argmax: _primal_only(torch.argmax),
    # a constant tensor's operator with a Dual on its right
    torch.Tensor.add: _add, torch.Tensor.sub: _sub, torch.Tensor.mul: _mul,
    torch.Tensor.div: _div,
}


def zero(p, dtype=None, lead: int = 0):
    """p as a Dual whose tangents are exact zeros of `dtype` (p's if None):
    an input off the differentiated directions whose dtype must take part
    in the promotion as a Dual's would."""
    return Dual(p, None, lead, p.dtype if dtype is None else dtype)


def jvp(f, x, tangents, *consts, lead: int = 0):
    """f(x, *consts) and its derivatives along each of `tangents` (B,
    *x.shape), (B, *out.shape), as B calls of torch.func.jvp give them.
    lead: leading dims of the primals that stand for a vmap over f (each
    slice a call of its own), which the dtype promotion does not see."""
    out = f(Dual(x, tangents, lead), *consts)
    return out.p, out.t
