"""Dimension tags for tensors: the port's audit of its own core.

Port of ``gcmiipy_tpu/utils/dimensions.py``.  The reference runs every
operation through pint units (reference ``constants.py:5`` and its unit
tests, ``test_primitive_1d.py:84-175``); the port, like the JAX package,
computes on plain SI tensors and moves the dimensional check to the tests.
:class:`Q` wraps a tensor (or a Python number, for the constants) with a
physical dimension, and its ``__torch_function__`` protocol lets the port's
plain core (:func:`gcmiipy_tpu_torch.dynamics.core25d.matsuno_timestep`)
run unchanged on tagged tensors, so that ``tests/test_torch_dimensions.py``
audits every term of the Matsuno step.

A plain tensor on the left of an operator defers to :class:`Q`'s
reflected operator: PyTorch turns the ``DimensionError`` (a ``TypeError``)
that its own dispatch meets into ``NotImplemented``.

Dimensions are exponent 4-vectors over (m, kg, s, K).  Addition, the
comparisons, ``where``, ``cat`` and ``stack`` demand equal dimensions (a bare
Python zero has every dimension); multiplication, division and ``matmul``
add exponents; non-integer powers demand dimensionless bases (the
``(P0/tp) ** kappa`` pattern); the transcendental functions demand
dimensionless arguments.  A plain tensor is dimensionless.  An operation
with no rule raises :class:`DimensionError`: a missing rule is a test
failure, never a silent pass-through.
"""

import numbers
import operator

import torch

# exponent vectors over (m, kg, s, K)
DIMENSIONLESS = (0, 0, 0, 0)
M = (1, 0, 0, 0)
KG = (0, 1, 0, 0)
S = (0, 0, 1, 0)
K = (0, 0, 0, 1)


class DimensionError(TypeError):
    """Raised when an operation mixes incompatible dimensions."""


def _combine(a, b, sign=1):
    return tuple(x + sign * y for x, y in zip(a, b))


def _scale(a, k):
    out = tuple(x * k for x in a)
    for x in out:
        if abs(x - round(x)) >= 1e-9:
            raise DimensionError(f"non-integer dimension exponent in {out}")
    return tuple(int(round(x)) for x in out)


def fmt(dim):
    """Render an exponent vector like 'm^1 kg^1 s^-2'."""
    names = ("m", "kg", "s", "K")
    parts = [f"{n}^{e}" for n, e in zip(names, dim) if e]
    return " ".join(parts) if parts else "dimensionless"


# derived dimensions used by the tests
PA = _combine(KG, _combine(M, _scale(S, 2)), sign=-1)   # kg m^-1 s^-2
M_PER_S = _combine(M, S, sign=-1)
M2_PER_S2 = _combine(_scale(M, 2), _scale(S, 2), sign=-1)
J_PER_KG_K = _combine(M2_PER_S2, K, sign=-1)            # R_d, C_p
M_PER_S2 = _combine(M, _scale(S, 2), sign=-1)           # g
KG_PER_M3 = _combine(KG, _scale(M, 3), sign=-1)


def dim_of(x):
    return x.dim if isinstance(x, Q) else DIMENSIONLESS


def mag(x):
    return x.mag if isinstance(x, Q) else x


def _require(cond, msg):
    if not cond:
        raise DimensionError(msg)


def _is_zero(x):
    """A bare Python zero: dimension-neutral."""
    return (isinstance(x, numbers.Number) and not isinstance(x, bool)
            and x == 0)


def _mags(x):
    """``x`` with every :class:`Q` replaced by its magnitude, through lists
    and tuples."""
    if isinstance(x, (list, tuple)):
        return type(x)(_mags(v) for v in x)
    return mag(x)


def _name(func):
    return getattr(func, "__qualname__", None) or getattr(func, "__name__",
                                                          repr(func))


# ------------------------------------------------------------------ rules
# Each rule takes the function and its arguments (Q or not) and returns the
# result: the function of the magnitudes, tagged with the result's dimension.

def _same_dim(func, *xs):
    dims = {dim_of(x) for x in xs if not _is_zero(x)}
    _require(len(dims) <= 1, f"{_name(func)} of "
             + " and ".join(fmt(d) for d in dims))
    return dims.pop() if dims else DIMENSIONLESS


def _keep(func, args, kwargs):
    """The result has the first argument's dimension (shifts, copies,
    casts, sums, indexing, negation)."""
    return Q(func(*_mags(args), **_mags(kwargs)), dim_of(args[0]))


def _same(func, args, kwargs):
    """A binary operation of equal dimensions: add, subtract, max, min."""
    d = _same_dim(func, args[0], args[1])
    return Q(func(*_mags(args), **_mags(kwargs)), d)


def _compare(func, args, kwargs):
    """A comparison of equal dimensions: an untagged bool tensor."""
    _same_dim(func, args[0], args[1])
    return func(*_mags(args), **_mags(kwargs))


def _mul(func, args, kwargs):
    return Q(func(*_mags(args), **_mags(kwargs)),
             _combine(dim_of(args[0]), dim_of(args[1])))


def _div(func, args, kwargs):
    return Q(func(*_mags(args), **_mags(kwargs)),
             _combine(dim_of(args[0]), dim_of(args[1]), sign=-1))


def _pow(func, args, kwargs):
    base, exp = args[0], args[1]
    _require(dim_of(exp) == DIMENSIONLESS, "exponent must be dimensionless")
    e = mag(exp)
    if dim_of(base) == DIMENSIONLESS:
        return Q(func(mag(base), e), DIMENSIONLESS)
    _require(isinstance(e, numbers.Number),
             f"a power of {fmt(dim_of(base))} needs a scalar exponent")
    return Q(func(mag(base), e), _scale(dim_of(base), e))


def _sqrt(func, args, kwargs):
    return Q(func(mag(args[0])), _scale(dim_of(args[0]), 0.5))


def _dimensionless(func, args, kwargs):
    _require(dim_of(args[0]) == DIMENSIONLESS,
             f"{_name(func)} needs a dimensionless argument, got "
             f"{fmt(dim_of(args[0]))}")
    return Q(func(*_mags(args), **_mags(kwargs)), DIMENSIONLESS)


def _untagged(func, args, kwargs):
    """Predicates and the like: the plain result."""
    return func(*_mags(args), **_mags(kwargs))


def _sequence(func, args, kwargs):
    """cat / stack: every member of one dimension."""
    d = _same_dim(func, *args[0])
    return Q(func(*_mags(args), **_mags(kwargs)), d)


def _where(func, args, kwargs):
    cond, a, b = args[0], args[1], args[2]
    _require(not isinstance(cond, Q), "where's condition carries a dimension")
    return Q(func(cond, mag(a), mag(b)), _same_dim(func, a, b))


def _clamp(func, args, kwargs):
    bounds = [b for b in list(args[1:]) + [kwargs.get("min"),
                                              kwargs.get("max")]
              if b is not None]
    return Q(func(*_mags(args), **_mags(kwargs)),
             _same_dim(func, args[0], *bounds))


T = torch.Tensor
_RULES = {
    torch.add: _same, torch.sub: _same, torch.maximum: _same,
    torch.minimum: _same, torch.mul: _mul, torch.matmul: _mul,
    torch.div: _div, torch.true_divide: _div, torch.pow: _pow,
    torch.sqrt: _sqrt, torch.exp: _dimensionless, torch.log: _dimensionless,
    torch.sin: _dimensionless, torch.cos: _dimensionless,
    torch.lt: _compare, torch.le: _compare, torch.gt: _compare,
    torch.ge: _compare, torch.eq: _compare, torch.ne: _compare,
    torch.cat: _sequence, torch.stack: _sequence,
    torch.where: _where, torch.clamp: _clamp, torch.ones_like: _untagged,
    torch.isnan: _untagged, torch.isfinite: _untagged,
}
for _f in (torch.roll, torch.cumsum, torch.sum, torch.mean, torch.max,
           torch.min, torch.abs, torch.neg, torch.zeros_like, torch.clone,
           T.to, T.sum, T.cumsum):
    _RULES[_f] = _keep
del _f


class Q:
    """A tensor (or Python number) tagged with a physical dimension.

    Thin on purpose: it implements the operations the port's core and
    thermodynamics reach, and raises on everything else.
    """

    def __init__(self, mag, dim=DIMENSIONLESS):
        self.mag = mag
        self.dim = tuple(dim)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        rule = _RULES.get(func)
        if rule is None:
            raise DimensionError(f"no dimension rule for {_name(func)}")
        return rule(func, args, kwargs or {})

    def __repr__(self):
        return f"Q({self.mag!r}, {fmt(self.dim)})"

    # -- tensor attributes and methods ------------------------------------
    @property
    def shape(self):
        return self.mag.shape

    @property
    def dtype(self):
        return self.mag.dtype

    @property
    def device(self):
        return self.mag.device

    @property
    def ndim(self):
        return self.mag.ndim

    def __len__(self):
        return len(self.mag)

    def __getattr__(self, name):
        """A tensor method (``x.to(...)``, ``x.sum()``, ...) through its
        rule: ``name`` must be a method of ``torch.Tensor`` with a rule."""
        method = getattr(torch.Tensor, name, None)
        if name.startswith("__") or not callable(method):
            raise AttributeError(name)

        def call(*args, **kwargs):
            return Q.__torch_function__(method, (Q,), (self,) + args, kwargs)

        return call

    def __getitem__(self, idx):
        return Q(self.mag[idx], self.dim)

    def __setitem__(self, idx, value):
        if isinstance(value, Q):
            _require(value.dim == self.dim,
                     f"cannot assign {fmt(value.dim)} into {fmt(self.dim)}")
            value = value.mag
        else:
            # bare zeros are dimension-neutral (the core's polar wall)
            _require(bool((torch.as_tensor(value) == 0).all()),
                     "only zero may be assigned without a dimension")
        self.mag[idx] = value

    # -- python operators: the same rules ---------------------------------
    def __add__(self, o):
        return _same(operator.add, (self, o), {})

    def __radd__(self, o):
        return _same(operator.add, (o, self), {})

    def __sub__(self, o):
        return _same(operator.sub, (self, o), {})

    def __rsub__(self, o):
        return _same(operator.sub, (o, self), {})

    def __mul__(self, o):
        return _mul(operator.mul, (self, o), {})

    def __rmul__(self, o):
        return _mul(operator.mul, (o, self), {})

    def __truediv__(self, o):
        return _div(operator.truediv, (self, o), {})

    def __rtruediv__(self, o):
        return _div(operator.truediv, (o, self), {})

    def __pow__(self, o):
        return _pow(operator.pow, (self, o), {})

    def __rpow__(self, o):
        return _pow(operator.pow, (o, self), {})

    def __matmul__(self, o):
        return _mul(operator.matmul, (self, o), {})

    def __neg__(self):
        return Q(-self.mag, self.dim)

    def __abs__(self):
        return Q(abs(self.mag), self.dim)

    def __lt__(self, o):
        return _compare(operator.lt, (self, o), {})

    def __le__(self, o):
        return _compare(operator.le, (self, o), {})

    def __gt__(self, o):
        return _compare(operator.gt, (self, o), {})

    def __ge__(self, o):
        return _compare(operator.ge, (self, o), {})

    # == and != go through the dimension check too: the default identity
    # comparison would answer False for mismatched dimensions, not raise
    def __eq__(self, o):
        return _compare(operator.eq, (self, o), {})

    def __ne__(self, o):
        return _compare(operator.ne, (self, o), {})

    # an elementwise __eq__ makes instances unhashable, like a tensor
    __hash__ = None
